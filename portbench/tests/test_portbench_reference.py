"""The plain references against the port at a tiny size on the CPU,
compared as numpy: logits of served tokens (prefill and every decode
step through the port's ``generate``), the training loss and its
gradients, and one AdamW update."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import seeds
from portbench.harness.context import Ctx, leaves
from portbench.tests.tiny import SEED, tiny_cell

RTOL, ATOL = 1e-4, 1e-5     # float32 sums in another order


def ctx_of(workload, seed=SEED, config=None):
    return Ctx(torch=torch, device=torch.device("cpu"),
               cell=tiny_cell(workload, config), seed=seed)


# each family's serving reference, under the serving cell's traffic
@pytest.mark.parametrize("config", ["internlm2-1.8b", "mamba2-2.7b"])
def test_served_logits_match_the_reference(config):
    from portbench.drivers import serve as S
    from repro_torch.launch.serve import serve
    ctx = ctx_of("mamba2-serve-doc2k", config=config)
    cfg = ctx.cell.program().program_config(ctx.conf)
    params = ctx.weights()
    tap = S.LogitTap(torch)
    tap.install()
    try:
        reqs = S.wave_requests(ctx, 0)
        toks, _ = serve(cfg, params, reqs, batch=len(reqs),
                        max_new=ctx.traffic["new_tokens"], device="cpu")
        got = torch.stack(tap.take(), dim=1).numpy()   # (B, new, V)
    finally:
        tap.uninstall()
    L = max(len(p) for p in reqs)
    new = ctx.traffic["new_tokens"]
    seq = np.zeros((len(reqs), L + new - 1), np.int64)
    for i, p in enumerate(reqs):
        seq[i, L - len(p):L] = p
        seq[i, L:] = toks[0][i, :-1]
    want = ctx.cell.reference().logits_at(
        ctx.conf, params, torch.as_tensor(seq),
        list(range(L - 1, L + new - 1))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (want.argmax(-1) == toks[0]).all()


def test_training_loss_and_gradients_match_the_reference():
    from portbench.drivers import train as T
    from repro_torch.models import model as M
    from repro_torch.train.train_step import value_and_grad
    ctx = ctx_of("internlm2-train-4k")
    cfg = ctx.cell.program().program_config(ctx.conf)
    ref = ctx.cell.reference()
    layout = ref.layout(ctx.conf)
    params = ctx.weights()
    b = T.batch(ctx, 0)
    (loss, _), grads = value_and_grad(
        lambda p, bb: M.loss_fn(cfg, p, bb, remat="full", ce_chunk=32),
        params, b)
    flat = {k: v.detach().clone().requires_grad_(True)
            for k, v in leaves(params, layout).items()}
    rloss = ref.loss(ctx.conf, T._tree_of(flat, [p for p, *_ in layout]),
                     b["tokens"], b["targets"])
    rgrads = torch.autograd.grad(rloss, list(flat.values()))
    np.testing.assert_allclose(float(loss), float(rloss.detach()),
                               rtol=1e-6)
    for (k, g), rg in zip(leaves(grads, layout).items(), rgrads):
        scale = float(rg.abs().max())
        np.testing.assert_allclose(g.numpy(), rg.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_adamw_update_matches_the_reference():
    from portbench.drivers import train as T
    from portbench.reference import adamw
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.optim.adamw import warmup_cosine
    ctx = ctx_of("internlm2-train-4k")
    tr = ctx.traffic
    layout = ctx.cell.reference().layout(ctx.conf)
    params = ctx.weights()
    gen = torch.Generator().manual_seed(seeds.derive(SEED, 9))
    grads = {k: torch.randn(v.shape, generator=gen) * 0.3
             for k, v in leaves(params, layout).items()}
    tree_g = T._tree_of(grads, [p for p, *_ in layout])
    state = {"m": T._tree_of({k: torch.randn(v.shape, generator=gen) * 0.01
                              for k, v in grads.items()},
                             [p for p, *_ in layout])}
    state["v"] = T._tree_of({k: torch.rand(v.shape, generator=gen) * 0.01
                             for k, v in grads.items()},
                            [p for p, *_ in layout])
    hp = T.hparams(tr)
    t = 4
    cfg = AdamWConfig(b1=tr["b1"], b2=tr["b2"], eps=tr["eps"],
                      weight_decay=tr["weight_decay"],
                      clip_norm=tr["clip_norm"])
    lr = warmup_cosine(tr["lr"], tr["warmup"], tr["total_steps"])(t)
    new_p, new_s, _ = adamw_update(params, tree_g, state, t, lr, cfg)
    p = {k: v.clone() for k, v in leaves(params, layout).items()}
    m = {k: v.clone() for k, v in leaves(state["m"], layout).items()}
    v2 = {k: v.clone() for k, v in leaves(state["v"], layout).items()}
    adamw.step(hp, p, grads, m, v2, t)
    assert float(adamw.learning_rate(hp, t)) == float(lr)
    for k, got in leaves(new_p, layout).items():
        np.testing.assert_allclose(got.numpy(), p[k].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    for k, got in leaves(new_s["m"], layout).items():
        # b1 m + (1 - b1) g cancels in places: a float32 ulp of the leaf
        np.testing.assert_allclose(got.numpy(), m[k].numpy(), rtol=1e-6,
                                   atol=1e-7 * float(m[k].abs().max()),
                                   err_msg=k)


@pytest.mark.parametrize("block", [8, 256])
def test_ssd_quadratic_form_is_the_recurrence(block, monkeypatch):
    """The reference's SSD (the quadratic form, in query blocks of
    ``block`` rows) against the step-by-step recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t."""
    from portbench.reference import mamba2
    monkeypatch.setattr(mamba2, "QUERY_BLOCK", block)
    gen = torch.Generator().manual_seed(3)
    R, S, H, P, G, N = 2, 37, 4, 3, 2, 5
    x = torch.randn(R, S, H, P, generator=gen)
    dt = torch.rand(R, S, H, generator=gen) * 0.5
    A = -torch.rand(H, generator=gen) * 3
    Bm = torch.randn(R, S, G, N, generator=gen)
    Cm = torch.randn(R, S, G, N, generator=gen)
    y = mamba2.ssd(x, dt, A, Bm, Cm)
    h = torch.zeros(R, H, P, N, dtype=torch.float64)
    ys = []
    for t in range(S):
        Bt = Bm[:, t].repeat_interleave(H // G, dim=1).double()
        Ct = Cm[:, t].repeat_interleave(H // G, dim=1).double()
        h = (h * torch.exp(dt[:, t] * A).double()[..., None, None]
             + dt[:, t].double()[..., None, None]
             * x[:, t].double()[..., None] * Bt[:, :, None, :])
        ys.append(torch.einsum("rhn,rhpn->rhp", Ct, h))
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-5)
