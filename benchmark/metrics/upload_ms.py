"""Host ms a batch in the program's ``upload`` span (the frames' pinned copy
and its queuing to the card), the mean over the batches ``submit_ms`` reads
(program span)."""

from benchmark.spans import batch_calls


def read(run):
    calls = batch_calls(run)
    if not calls:
        return None
    return sum(u for _, u in calls) / len(calls)
