"""Training: the port's one-process train step
(``repro_torch.train.train_step.make_train_step``) with AdamW, on
batches of uniform random tokens drawn from the seed.

Set-up makes the weights and the optimiser state, builds the step once
and takes the traffic's ``checked_steps`` steps with it through the
window's own call and feed, on rows that all differ; those steps warm
the step up (its first call pays every lazy start).  It keeps what the
check compares: each step's loss, each leaf's norm of the first
gradient as the optimiser took it (its first moment after one step over
1 - b1), and each leaf's norm of the parameters' change over the checked
steps.  The window then goes on with the same step, the same state and
the same feed, a synchronise after every step, until ``seconds`` have
passed; ``train_tok_per_s`` is its tokens over its seconds.

The check, once the window has closed and the program's state is
freed, makes the weights again and follows the checked steps with the
plain reference (``reference/<family>.py``'s loss, ``reference/
adamw.py``) on the same batches.
"""
from __future__ import annotations

import time

from portbench.harness import checks, seeds
from portbench.harness.context import leaves, check_layout, log
from portbench.reference import adamw as ref_adamw

def hparams(tr: dict) -> dict:
    return {k: tr[k] for k in ("lr", "warmup", "total_steps", "min_lr_frac",
                               "b1", "b2", "eps", "weight_decay",
                               "clip_norm")}


def batch(ctx, t: int, rows=None):
    """Step ``t``'s batch: (B, S + 1) uniform tokens from the seed, the
    first S as input and the last S as targets."""
    torch, tr = ctx.torch, ctx.traffic
    with torch.profiler.record_function("portbench.feed"):
        gen = torch.Generator(device=ctx.device).manual_seed(
            seeds.derive(ctx.seed, seeds.TRAFFIC, t))
        x = torch.randint(0, ctx.cell.config["vocab_size"],
                          (tr["batch"], tr["seq"] + 1), generator=gen,
                          device=ctx.device)
    if rows is not None:
        x = x[:rows]
    return {"tokens": x[:, :-1], "targets": x[:, 1:]}


def norm(x) -> float:
    """A leaf's norm, summed in float64, so that the comparison reads the
    leaves' difference and not the rounding of their norms (p - p0 of
    two nearby float32 values is exact)."""
    import torch
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def _program_step(ctx, cfg):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainHParams, make_train_step
    tr = ctx.traffic
    hp = TrainHParams(
        lr=tr["lr"], warmup=tr["warmup"], total_steps=tr["total_steps"],
        adamw=AdamWConfig(b1=tr["b1"], b2=tr["b2"], eps=tr["eps"],
                          weight_decay=tr["weight_decay"],
                          clip_norm=tr["clip_norm"]),
        remat=tr["remat"], ce_chunk=tr["ce_chunk"], opt_impl="adamw")
    if tr["min_lr_frac"] != 0.1:
        raise ValueError("the port's schedule ends at 0.1 of the rate")
    step = make_train_step(cfg, hp)
    if ctx.fault == "unchanged":
        def step_unchanged(params, opt, b, t):
            _, _, met = step(params, opt, b, t)
            return params, opt, met
        return step_unchanged
    if ctx.fault == "half":
        def step_half(params, opt, b, t):
            half = b["tokens"].shape[0] // 2
            return step(params, opt, {k: v[:half] for k, v in b.items()}, t)
        return step_half
    return step


def setup(ctx):
    from repro_torch.optim.adamw import init_opt_state
    torch, tr = ctx.torch, ctx.traffic
    layout = ctx.cell.reference().layout(ctx.conf)
    cfg = ctx.cell.program().program_config(ctx.conf)
    check_layout(cfg, layout)
    params = ctx.weights()
    opt = init_opt_state(params)
    step = _program_step(ctx, cfg)
    got = {"losses": []}
    for t in range(tr["checked_steps"]):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch(ctx, t), t)
        got["losses"].append(float(met["loss"]))
        ctx.sync()
        log(f"set-up step {t}: loss {got['losses'][-1]!r}, "
            f"{time.perf_counter() - t0:.3f} s")
        if t == 0:
            got["grad_norms"] = {
                k: norm(m) / (1 - tr["b1"])
                for k, m in leaves(opt["m"], layout).items()}
    init = ctx.weights()
    now = leaves(params, layout)
    got["change_norms"] = {k: norm(now[k] - p0)
                           for k, p0 in leaves(init, layout).items()}
    del init, now
    ctx.free()
    return {"params": params, "opt": opt, "step": step, "next": len(
        got["losses"]), "got": got, "cfg": cfg}


def window(ctx, state, seconds: float) -> dict:
    tr = ctx.traffic
    # the state is held here alone: a step's old state is freed as the
    # next one is made, as a training loop holds it
    step, params, opt = state["step"], state.pop("params"), state.pop("opt")
    n = 0
    t0 = ctx.sync()
    while True:
        t = state["next"]
        params, opt, _ = step(params, opt, batch(ctx, t), t)
        ctx.sync()
        state["next"] += 1
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    secs = time.perf_counter() - t0
    state["params"], state["opt"] = params, opt
    tokens = n * tr["batch"] * tr["seq"]
    return {"steps": n, "tokens": tokens, "seconds": secs,
            "attempted": n, "failed": 0,
            "e2e": {"train_tok_per_s": tokens / secs},
            "model_flops": n * ctx.cell.program().train_step_flops(
                ctx.conf, tr["batch"], tr["seq"])}


def reference_run(ctx, *, tf32=False, rows=None) -> dict:
    """The checked steps of the plain reference from freshly made
    weights: losses, the first clipped gradient's leaf norms and the
    change's leaf norms.  ``tf32`` runs its float32 products in TF32
    (the control); ``rows`` keeps the first rows of each batch (a
    fault)."""
    from portbench.harness.card import float32_settings
    torch, tr = ctx.torch, ctx.traffic
    ref = ctx.cell.reference()
    layout = ref.layout(ctx.conf)
    hp = hparams(tr)
    float32_settings(torch, tf32)
    try:
        tree = ctx.weights()
        flat = {k: v.detach().requires_grad_(True)
                for k, v in leaves(tree, layout).items()}
        names = [ctx_path for ctx_path, *_ in layout]
        m = {k: torch.zeros_like(v) for k, v in flat.items()}
        v2 = {k: torch.zeros_like(v) for k, v in flat.items()}
        out = {"losses": []}
        for t in range(tr["checked_steps"]):
            b = batch(ctx, t, rows)
            params = _tree_of(flat, names)
            loss = ref.loss(ctx.conf, params, b["tokens"], b["targets"])
            grads = torch.autograd.grad(loss, list(flat.values()))
            out["losses"].append(float(loss.detach()))
            del loss, params
            clipped = ref_adamw.step(hp, flat, dict(zip(flat, grads)), m,
                                     v2, t)
            if t == 0:
                out["grad_norms"] = {k: norm(g) for k, g in clipped.items()}
            del grads, clipped
        del m, v2, tree
        ctx.free()
        init = leaves(ctx.weights(), layout)
        out["change_norms"] = {k: norm(flat[k].detach() - init[k])
                               for k in flat}
        del init, flat
        ctx.free()
        return out
    finally:
        float32_settings(torch, False)


def _tree_of(flat: dict, paths):
    from portbench.harness.weights import tree_set
    tree: dict = {}
    for p in paths:
        tree_set(tree, p, flat["/".join(str(x) for x in p)])
    return tree


def release(ctx, state):
    for k in ("params", "opt", "step"):
        state.pop(k, None)
    ctx.free()


def check(ctx, state) -> dict:
    release(ctx, state)
    ref = reference_run(ctx)
    return checks.train_numbers(state["got"], ref)


def calibrate(ctx, state, control: bool) -> dict:
    """The program's numbers for this seed and, with ``control``, the
    control's (the reference in TF32 in the program's place) and the
    planted half-batch fault's (the reference on half of each batch):
    {"program": ..., "control": ..., "fault_half": ...}."""
    release(ctx, state)
    ref = reference_run(ctx)
    runs = {"program": state["got"]}
    if control:
        runs["control"] = reference_run(ctx, tf32=True)
        runs["fault_half"] = reference_run(ctx,
                                           rows=ctx.traffic["batch"] // 2)
    out = {k: checks.train_numbers(v, ref) for k, v in runs.items()}
    keep = checks.moving_leaves(ref["grad_norms"])
    out["leaves"] = {k: {"grad": checks.leaf_gaps(v["grad_norms"],
                                                  ref["grad_norms"]),
                         "change": checks.leaf_gaps(v["change_norms"],
                                                    ref["change_norms"],
                                                    keep)}
                     for k, v in runs.items()}
    return out
