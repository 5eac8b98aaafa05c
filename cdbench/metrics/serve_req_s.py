"""serve_req_s: requests answered a second: answered requests over the
window, from its opening to the last response."""


def read(run):
    return len(run.done) / run.window_s if run.done else None
