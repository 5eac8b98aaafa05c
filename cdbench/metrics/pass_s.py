"""pass_s: seconds a detection pass, index build included: the window's
seconds over its completed passes (passes run back to back)."""


def read(run):
    done = run.done
    return run.window_s / len(done) if done else None
