"""Process start to the first timed request: imports, keys, the server's
key operands, program tracing, encryption of the requests, warm-up and
the lead-in to steady load."""


def read(run):
    return run.setup_s
