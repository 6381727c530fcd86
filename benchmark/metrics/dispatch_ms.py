"""Host ms a batch in the program's ``predict_batch`` span less its
``upload`` span: queuing the forward, and any wait on the card inside it;
the mean over the batches ``submit_ms`` reads (program span)."""

from benchmark.spans import batch_calls


def read(run):
    calls = batch_calls(run)
    if not calls:
        return None
    return sum(r - u for r, u in calls) / len(calls)
