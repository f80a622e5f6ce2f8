"""prefill_tok_per_s.serve: the window's real prompt tokens over the
sum of the server's prefill walls (``generate(walls=)``'s ``prefill_s``)."""


def read(record):
    w = record["window"]
    return w["prompt_tokens"] / w["prefill_s"] if w.get("prefill_s") else None
