"""decode_ms_per_step.serve: the sum of the server's decode walls
(``generate(walls=)``'s ``decode_s``) over the window's decode steps, in ms."""


def read(record):
    w = record["window"]
    if not w.get("decode_steps"):
        return None
    return 1e3 * w["decode_s"] / w["decode_steps"]
