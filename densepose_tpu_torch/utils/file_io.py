"""Path resolution + cached downloads (the port's copy of
densepose_tpu/utils/file_io.py).

Resolves the ``detectron2://`` scheme to
``https://dl.fbaipublicfiles.com/detectron2/``, rewrites OneDrive share links
(``https://1drv.ms/...``) to their direct-download URL, as iopath's
``OneDrivePathHandler`` and the JAX package do, and caches http(s) downloads in
``$DENSEPOSE_TPU_CACHE`` (default ``~/.cache/densepose_tpu``, the JAX
package's cache, so a checkpoint fetched by either package serves both).
With ``DENSEPOSE_TPU_OFFLINE`` set, a file that is not cached raises
``IOError`` and nothing is downloaded.
"""

from __future__ import annotations

import base64
import hashlib
import logging
import os
import urllib.request

logger = logging.getLogger(__name__)

DETECTRON2_PREFIX = "detectron2://"
DETECTRON2_URL = "https://dl.fbaipublicfiles.com/detectron2/"
ONEDRIVE_PREFIX = "https://1drv.ms/"


def onedrive_download_url(share_link: str) -> str:
    """A OneDrive share link's direct-download URL: the link in unpadded
    base64url after 'u!' (iopath's OneDrivePathHandler; the JAX package's
    ``onedrive_download_url``)."""
    b64 = base64.urlsafe_b64encode(share_link.encode()).decode().rstrip("=")
    return f"https://api.onedrive.com/v1.0/shares/u!{b64}/root/content"


def cache_dir() -> str:
    return os.path.expanduser(os.environ.get("DENSEPOSE_TPU_CACHE", "~/.cache/densepose_tpu"))


def get_local_path(path: str) -> str:
    """Local path passthrough; detectron2://, OneDrive share links and
    http(s):// resolve into the cache directory (downloading on first use),
    under the name the JAX package gives the same path."""
    if path.startswith(DETECTRON2_PREFIX):
        path = DETECTRON2_URL + path[len(DETECTRON2_PREFIX):]
    if path.startswith(ONEDRIVE_PREFIX):
        path = onedrive_download_url(path)
    if not path.startswith(("http://", "https://")):
        return path
    digest = hashlib.sha1(path.encode()).hexdigest()[:16]
    fname = os.path.basename(path.split("?")[0]) or "download"
    local = os.path.join(cache_dir(), f"{digest}_{fname}")
    if os.path.exists(local):
        return local
    if os.environ.get("DENSEPOSE_TPU_OFFLINE"):
        raise IOError(f"DENSEPOSE_TPU_OFFLINE set and {path!r} not cached at {local!r}")
    os.makedirs(cache_dir(), exist_ok=True)
    logger.info("downloading %s -> %s", path, local)
    tmp = f"{local}.{os.getpid()}.tmp"
    try:
        urllib.request.urlretrieve(path, tmp)
    except OSError as e:
        raise IOError(f"could not download {path!r} (no network?); place the file at "
                      f"{local!r} manually") from e
    os.replace(tmp, local)
    return local
