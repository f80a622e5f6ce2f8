"""Serving: the port's batched-request server
(``repro_torch.launch.serve.serve`` -> ``serve.decode.generate``) in
closed waves of ``batch`` requests, each left-padded with token 0 to its
longest prompt (the pads are attended, as the server defines it),
prefilled once and decoded greedily for ``new_tokens`` tokens.

Every wave has the same prompt lengths: ``batch`` lengths spread evenly
over [``prompt_min``, ``prompt_max``] (the midpoints of ``batch`` equal
strata), in an order and with tokens (uniform over the tokenizer's ids,
``token_ids`` where the configuration pads its vocabulary past them,
less the pad 0) drawn from the seed and the wave's index.  So every seed does
the same work and every wave has the same shapes.

Set-up makes the weights and serves one warm-up wave.  The window serves
waves until ``seconds`` have passed; the wave in flight then finishes,
so the window holds whole waves.  ``serve_tok_per_s`` is the real prompt
tokens (pads not counted) plus the generated tokens over the window's
seconds.  The logits the window's prefill and decode steps return are
kept (``serve.decode.make_prefill_step`` and ``make_serve_step`` are
wrapped from here, in every run), so the check reads the logits the
served tokens came from.

The check, once the window has closed and the program's weights are
freed, makes the weights again, samples ``check_requests`` of the
finished requests from the seed, the longest first, and runs the plain
reference once over each one's padded prompt and served tokens.
"""
from __future__ import annotations

import time

import numpy as np

from portbench.harness import checks, seeds
from portbench.harness.context import check_layout, log

WARM_WAVE = 1 << 40


def lengths(tr: dict):
    n, lo, hi = tr["batch"], tr["prompt_min"], tr["prompt_max"]
    return [lo + (2 * i + 1) * (hi - lo) // (2 * n) for i in range(n)]


def wave_requests(ctx, w: int):
    """Wave ``w``'s prompts: a list of int32 numpy arrays."""
    rng = seeds.rng(ctx.seed, seeds.TRAFFIC, w)
    V = ctx.conf.get("token_ids", ctx.conf["vocab_size"])
    return [rng.integers(1, V, size=n, dtype=np.int64).astype(np.int32)
            for n in rng.permutation(lengths(ctx.traffic))]


class LogitTap:
    """Keeps a copy of the logits each prefill and decode step of the
    program returns, in order, on the device."""

    def __init__(self, torch):
        self.torch = torch
        self.kept = []
        self._saved = []

    def install(self):
        import repro_torch.serve.decode as SD
        tap = self

        def wrap_prefill(make):
            def maker(*a, **k):
                f = make(*a, **k)

                def prefill_step(params, batch):
                    logits, caches = f(params, batch)
                    tap.kept.append(logits.detach().clone())
                    return logits, caches
                return prefill_step
            return maker

        def wrap_serve(make):
            def maker(*a, **k):
                f = make(*a, **k)

                def serve_step(*args):
                    tok, logits, caches = f(*args)
                    tap.kept.append(logits.detach().clone())
                    return tok, logits, caches
                return serve_step
            return maker
        for name, wrap in (("make_prefill_step", wrap_prefill),
                           ("make_serve_step", wrap_serve)):
            orig = getattr(SD, name)
            self._saved.append((SD, name, orig))
            setattr(SD, name, wrap(orig))

    def take(self):
        out, self.kept = self.kept, []
        return out

    def uninstall(self):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()


def _serve_wave(ctx, state, w: int):
    from repro_torch.launch.serve import serve
    tr = ctx.traffic
    with ctx.torch.profiler.record_function("portbench.feed"):
        reqs = wave_requests(ctx, w)
    toks, walls = serve(state["cfg"], state["params"], reqs,
                        batch=tr["batch"], max_new=tr["new_tokens"],
                        device=ctx.device)
    tokens = toks[0]
    if ctx.fault == "token":
        tokens = tokens.copy()
        tokens[:, -1] = (tokens[:, -1] + 1) % ctx.conf["vocab_size"]
    return reqs, tokens, walls[0], state["tap"].take()


def setup(ctx):
    torch = ctx.torch
    layout = ctx.cell.reference().layout(ctx.conf)
    cfg = ctx.cell.program().program_config(ctx.conf)
    check_layout(cfg, layout)
    tap = LogitTap(torch)
    tap.install()
    state = {"cfg": cfg, "params": ctx.weights(), "tap": tap, "waves": []}
    t0 = time.perf_counter()
    _serve_wave(ctx, state, WARM_WAVE)
    ctx.sync()
    log(f"warm-up wave: {time.perf_counter() - t0:.3f} s")
    return state


def window(ctx, state, seconds: float = None, waves: int = None) -> dict:
    """Waves until ``seconds`` have passed (or, for calibration, exactly
    ``waves`` waves)."""
    tr, fam = ctx.traffic, ctx.cell.program()
    record = state["waves"]
    t0 = ctx.sync()
    w = 0
    while True:
        reqs, tokens, walls, logits = _serve_wave(ctx, state, w)
        record.append({"requests": reqs, "tokens": tokens, "walls": walls,
                       "logits": logits})
        w += 1
        if waves is not None:
            if w >= waves:
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    secs = ctx.sync() - t0
    new = tr["new_tokens"]
    prompt = sum(len(p) for r in record for p in r["requests"])
    n_req = sum(len(r["requests"]) for r in record)
    flops = 0.0
    for r in record:
        for p in r["requests"]:
            flops += fam.prefill_flops(ctx.conf, len(p))
            flops += sum(fam.decode_flops(ctx.conf, len(p) + j)
                         for j in range(1, new))
    return {"waves": len(record), "requests": n_req,
            "prompt_tokens": prompt, "generated": n_req * new,
            "seconds": secs, "attempted": n_req, "failed": 0,
            "prefill_s": sum(r["walls"]["prefill_s"] for r in record),
            "decode_s": sum(r["walls"]["decode_s"] for r in record),
            "decode_steps": len(record) * (new - 1),
            "model_flops": flops,
            "e2e": {"serve_tok_per_s": (prompt + n_req * new) / secs}}


def sample(ctx, record) -> list:
    """(wave, row) of the requests the check compares: the longest
    prompt first, then others drawn from the seed."""
    every = [(w, i) for w, r in enumerate(record)
             for i in range(len(r["requests"]))]
    longest = max(every, key=lambda wi: len(record[wi[0]]["requests"][wi[1]]))
    rest = [wi for wi in every if wi != longest]
    rng = seeds.rng(ctx.seed, seeds.SAMPLE)
    k = min(ctx.traffic["check_requests"], len(every)) - 1
    picked = [rest[i] for i in sorted(rng.choice(len(rest), size=k,
                                                 replace=False))]
    return [longest] + picked


def release(ctx, state):
    """Free the program's weights and every wave's logits but those of
    the sampled requests; returns what the check reads."""
    torch = ctx.torch
    state["tap"].uninstall()
    record = state["waves"]
    picks = sample(ctx, record)
    rows = []
    for w, i in picks:
        r = record[w]
        prompt = r["requests"][i]
        L = max(len(p) for p in r["requests"])
        padded = np.zeros(L, np.int64)
        padded[L - len(prompt):] = prompt
        logits = (torch.stack([x[i] for x in r["logits"]])
                  if len(r["logits"]) == r["tokens"].shape[1] else None)
        rows.append({"padded": padded, "served": r["tokens"][i].astype(
            np.int64), "logits": logits})
    for k in ("params", "tap", "waves"):
        state.pop(k, None)
    ctx.free()
    return rows


def reference_logits(ctx, rows):
    """The float32 reference's logits at each sampled request's served
    positions ((n_rows, new_tokens, V), on the device), teacher-forced on
    its padded prompt and served tokens."""
    torch = ctx.torch
    ref = ctx.cell.reference()
    params = ctx.weights()
    out = [None] * len(rows)
    by_len = {}
    for j, r in enumerate(rows):
        by_len.setdefault(len(r["padded"]), []).append(j)
    per = ctx.traffic["reference_rows"]
    for L, js in by_len.items():
        new = len(rows[js[0]]["served"])
        where = list(range(L - 1, L + new - 1))
        for a in range(0, len(js), per):
            part = js[a:a + per]
            seq = torch.as_tensor(np.stack([
                np.concatenate([rows[j]["padded"], rows[j]["served"][:-1]])
                for j in part]), device=ctx.device)
            for j, g in zip(part, ref.logits_at(ctx.conf, params, seq,
                                                 where)):
                out[j] = g
    del params
    ctx.free()
    return torch.stack(out)


def numbers(ctx, rows, ref_logits) -> dict:
    torch = ctx.torch
    served = torch.as_tensor(np.concatenate([r["served"] for r in rows]),
                             device=ctx.device)
    have = all(r["logits"] is not None for r in rows)
    prog = (torch.cat([r["logits"] for r in rows]) if have else None)
    if not have:
        log("the program's logits were not read: serve.decode.generate "
            "did not call make_prefill_step and make_serve_step once a "
            "token")
    return checks.serve_numbers(prog, ref_logits.reshape(
        -1, ref_logits.shape[-1]), served)


def check(ctx, state) -> dict:
    rows = release(ctx, state)
    return numbers(ctx, rows, reference_logits(ctx, rows))


def control_numbers(ctx, rows) -> dict:
    """The control's numbers: the reference in TF32 put in the program's
    place.  ``logit_err`` and ``token_gap`` at the served positions as
    the run reads them, and ``token_gap_all``: the gap, in the float32
    reference's logits, of the token the TF32 reference puts first, at
    every position of the same padded prompts and served tokens."""
    from portbench.harness.card import float32_settings
    torch = ctx.torch
    ref = ctx.cell.reference()
    params = ctx.weights()
    W = params["lm_head"]
    err = gap = gap_all = 0.0
    try:
        for r in rows:
            seq = torch.as_tensor(np.concatenate(
                [r["padded"], r["served"][:-1]])[None], device=ctx.device)
            L, new = len(r["padded"]), len(r["served"])
            float32_settings(torch, False)
            h32 = ref.final_hidden(ctx.conf, params, seq)[0]
            float32_settings(torch, True)
            hlo = ref.final_hidden(ctx.conf, params, seq)[0]
            for a in range(0, seq.shape[1], 1024):
                float32_settings(torch, False)
                l32 = h32[a:a + 1024] @ W
                float32_settings(torch, True)
                llo = hlo[a:a + 1024] @ W
                top = llo.argmax(dim=-1, keepdim=True)
                g = l32.max(dim=-1).values - l32.gather(1, top)[:, 0]
                gap_all = max(gap_all, float(g.max()))
                lo, hi = max(a, L - 1), min(a + 1024, L + new - 1)
                if lo < hi:
                    err = max(err, float((llo[lo - a:hi - a]
                                          - l32[lo - a:hi - a]).abs().max()))
                    gap = max(gap, float(g[lo - a:hi - a].max()))
                del l32, llo
    finally:
        float32_settings(torch, False)
    del params
    ctx.free()
    return {"token_gap": gap, "logit_err": err, "token_gap_all": gap_all}


def calibrate(ctx, state, control: bool) -> dict:
    """The program's numbers for this seed and, with ``control``, the
    control's (``control_numbers``)."""
    rows = release(ctx, state)
    out = {"program": numbers(ctx, rows, reference_logits(ctx, rows))}
    if control:
        out["control"] = control_numbers(ctx, rows)
    return out
