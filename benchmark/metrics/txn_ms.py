"""Host ms a frame in `RenderBackend.send_transaction` (resource updates,
scene ops and the scene build, frame ops): the mean over the window's
frames of the harness's span around the call."""


def read(run):
    spans = run.spans.get("txn") or []
    return sum(spans) / len(spans) if spans else None
