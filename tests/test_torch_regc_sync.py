"""The port's RegC gradient sync (``repro_torch.regc_sync.policies``)
against the reference's (``repro.regc_sync.policies``) on the CPU.

In process: ``_quant`` / ``_dequant`` codes and scales bit-equal to the
reference's compiled ones (``jax.jit``: XLA folds ``max / 127.0`` into a
multiplication by the float32 reciprocal, which the op-by-op reference
does not) on seeded vectors (zero kept at zero); ``_add_dequant``, the
reduce-scatter's add, bit-equal to XLA's compiled ``a + q * s`` (a fused
multiply-add, one rounding), float64's double rounding at a float32
midpoint included; the quantization error
within half a step plus a margin that scales with |x| (float32 rounding
of ``x / scale`` and ``q * scale``, each about |x| * 6e-8), bucket round
trips exact and bucket counts and sizes equal to the reference's, policy
validation.

Across ranks: one JAX subprocess with 8 host devices (as
``tests/test_regc_sync.py`` runs its multi-device checks) writes the
inputs and the reference's results; 8 spawned gloo ranks of the port
(``launch.ranks.spawn_ranks``) run the same inputs:

* ``ring_allreduce_int8``: every rank's result bit-equal to the
  reference's (the ring adds two operands at a time in a fixed order,
  so it is deterministic); on the reference test's input within its ring
  bound ``|ring - psum| / (|psum| + 1e-3) < 0.05`` of the float64 sum;
* ``barrier_sync_grads`` at object and bucket granularity: the psum
  policies within 1e-6 of each leaf's largest |value| of the reference's
  (gloo and XLA add the 8 terms in other orders), the int8 ring bit-equal;
* ``span_reduce`` sum, mean and max (within 1e-6 relative; max equal);
* a (2, 4) ``("pod", "data")`` mesh with int8_ring (an all-reduce of two
  terms over "pod", then the ring over "data"): bit-equal;
* every rank's results bit-equal to rank 0's, and each case's counted
  collectives (kind, bytes this rank sends, messages) equal to the rule.

Default runs sample the seeded cases; ``FUZZ_TORCH=1`` runs all.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.regc_sync import policies as P
from repro_torch.utils.tree import tree_flatten, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
FUZZ = os.environ.get("FUZZ_TORCH") == "1"
WORLD = 8
QUANT_SEEDS = range(40) if FUZZ else range(0, 40, 8)
BUCKET_SEEDS = range(24) if FUZZ else range(0, 24, 6)
# (n a rank, magnitude) of the ring's seeded inputs
RING_CASES = ((1001, 1.0), (5, 1e3), (64, 1e-3), (333, 10.0), (1, 2.0),
              (4096, 0.5), (17, 1e-6), (2048, 100.0))
RING_SAMPLE = RING_CASES if FUZZ else RING_CASES[:4]
PSUM_TOL = 1e-6
# the synced trees: leaf shapes a rank
GRAD_SHAPES = {"a": (1, 64), "b": (8, 8), "c": (1001,), "d": (3, 5, 7)}
POLICIES = {
    "object": P.RegCSyncPolicy(granularity="object"),
    "bucket128": P.RegCSyncPolicy(granularity="bucket", bucket_bytes=128),
    "bucket4k": P.RegCSyncPolicy(granularity="bucket", bucket_bytes=4096),
    "bucket_default": P.RegCSyncPolicy(),
    "ring_object": P.RegCSyncPolicy(granularity="object",
                                    compression="int8_ring"),
    "ring_bucket4k": P.RegCSyncPolicy(granularity="bucket",
                                      bucket_bytes=4096,
                                      compression="int8_ring"),
}
POD_POLICIES = ("ring_object", "ring_bucket4k", "object")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


def _quant_input(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 3000))
    x = rng.randn(n).astype(np.float32) * np.float32(
        10.0 ** rng.uniform(-4, 4))
    if seed % 5 == 0:
        x[rng.randint(0, n, size=max(1, n // 7))] = 0.0
    if seed % 4 == 0:     # scale 1 (max |x| = 127): exact ties at k + 0.5
        x = (rng.randint(-127, 127, size=n) + 0.5).astype(np.float32)
        x[0] = 127.0
    return x


@pytest.mark.parametrize("seed", QUANT_SEEDS)
def test_quant_matches_reference(seed):
    jnp = pytest.importorskip("jax.numpy")
    from repro.regc_sync.policies import _dequant as ref_dequant
    from repro.regc_sync.policies import _quant as ref_quant
    jax = pytest.importorskip("jax")
    x = _quant_input(seed)
    q, s = P._quant(torch.from_numpy(x))
    rq, rs = jax.jit(ref_quant)(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    d = P._dequant(q, s)
    assert d.numpy().tobytes() == np.asarray(ref_dequant(rq, rs)).tobytes()
    # the error bound: half a step, plus the float32 roundings of
    # x / scale and q * scale, each within |x| * 2**-24 (and s * 2**-24)
    err = np.abs(d.numpy().astype(np.float64) - x)
    bound = 0.5 * float(s) * (1 + 2.0 ** -22) + np.abs(x) * 2.0 ** -22
    assert (err <= bound).all(), (err - bound).max()
    assert (d.numpy()[x == 0] == 0).all()


def test_add_dequant_is_one_rounding():
    """Against XLA's compiled ``a + q * s`` on the CPU: random operands of
    every exponent gap, and a case where float64 lands on the float32
    midpoint 1 + 2**-24 while the exact sum, 1 + 2**-24 + 2**-54, lies
    beyond it (65 * m = 2**30 + 1 for the 24-bit m below)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    rng = np.random.RandomState(5)
    n = 200_000 if FUZZ else 20_000
    a = (rng.randn(n) * 2.0 ** rng.randint(-30, 30, n)).astype(np.float32)
    q = rng.randint(-127, 128, n).astype(np.int8)
    s = (rng.rand(n) * 2.0 ** rng.randint(-60, 10, n)).astype(np.float32)
    m = np.float32(16519105 * 2.0 ** -54)
    assert 65 * 16519105 == 2 ** 30 + 1
    a = np.concatenate([a, np.float32([1.0, -1.0, 1.0, 2.0 ** 20])])
    q = np.concatenate([q, np.int8([65, -65, -65, 65])])
    s = np.concatenate([s, np.float32([m, m, m, m * 2.0 ** 20])])
    fma = jax.jit(lambda a, q, s: a + q.astype(jnp.float32) * s)
    want = np.asarray(fma(jnp.asarray(a), jnp.asarray(q), jnp.asarray(s)))
    got = P._add_dequant(torch.from_numpy(a), torch.from_numpy(q),
                         torch.from_numpy(s)).numpy()
    assert want[-4] == np.float32(1 + 2.0 ** -23)      # rounded up, once
    assert want[-3] == -want[-4]
    assert got.tobytes() == want.tobytes(), np.nonzero(got != want)


def test_quant_keeps_zero():
    q, s = P._quant(torch.zeros(16))
    assert (q == 0).all() and float(s) == np.float32(1e-30)
    assert (P._dequant(q, s) == 0).all()


def _tree_of(shapes, rng, dtypes=None):
    return {f"p{i}": torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        (dtypes or {}).get(i, torch.float32)) for i, s in enumerate(shapes)}


@pytest.mark.parametrize("seed", BUCKET_SEEDS)
def test_buckets_round_trip_and_match_reference(seed):
    jnp = pytest.importorskip("jax.numpy")
    from repro.regc_sync.policies import _flatten_to_buckets as ref_flatten
    rng = np.random.RandomState(seed)
    shapes = [tuple(int(rng.randint(1, 9)) for _ in range(rng.randint(1, 4)))
              for _ in range(rng.randint(1, 9))]
    bucket_bytes = int(rng.choice([8, 64, 200, 512, 4096]))
    dtypes = {0: torch.bfloat16} if seed % 3 == 1 else None
    tree = _tree_of(shapes, rng, dtypes)
    buckets, shp, template = P._flatten_to_buckets(tree, bucket_bytes)
    assert all(b.dtype == torch.float32 for b in buckets)
    out = P._unflatten_buckets(buckets, shp, template)
    for (ka, a), (kb, b) in zip(tree_flatten(tree), tree_flatten(out)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b)
    ref = {k: jnp.asarray(v.float().numpy()) for k, v in tree.items()}
    want, _, _ = ref_flatten(ref, bucket_bytes)
    assert [tuple(b.shape) for b in buckets] == [b.shape for b in want]
    for b, w in zip(buckets, want):
        np.testing.assert_array_equal(b.numpy(), np.asarray(w))


def test_bucket_sizes_respect_threshold():
    jnp = pytest.importorskip("jax.numpy")
    from repro.regc_sync.policies import _flatten_to_buckets as ref_flatten
    tree = {f"p{i}": torch.ones(1024) for i in range(16)}
    buckets, _, _ = P._flatten_to_buckets(tree, 8192)   # 2 leaves a bucket
    assert len(buckets) == 8
    assert all(b.numel() * 4 >= 8192 for b in buckets[:-1])
    want, _, _ = ref_flatten({k: jnp.ones(1024) for k in tree}, 8192)
    assert [b.numel() for b in buckets] == [b.size for b in want]


def test_policy_validation():
    with pytest.raises(AssertionError):
        P.RegCSyncPolicy(ordinary_sync="nope")
    with pytest.raises(AssertionError):
        P.RegCSyncPolicy(granularity="page")
    with pytest.raises(AssertionError):
        P.RegCSyncPolicy(compression="fp8")
    assert P.RegCSyncPolicy() == P.RegCSyncPolicy("lazy", "bucket", 64 << 20,
                                                  None)


def test_collectives_need_a_mesh():
    with pytest.raises(TypeError, match="mesh"):
        P.span_reduce(torch.ones(()), ("data",))
    with pytest.raises(TypeError, match="mesh"):
        P.barrier_sync_grads({"w": torch.ones(3)}, ("data",),
                             P.RegCSyncPolicy())
    # a ring of one rank returns its input and reads no mesh
    assert P.ring_allreduce_int8(torch.ones(3), "data", 1,
                                 mesh=None).tolist() == [1.0] * 3


# ---------------------------------------------------------------------------
# 8 ranks against the reference's 8 host devices
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.regc_sync.policies import (RegCSyncPolicy, barrier_sync_grads,
                                      ring_allreduce_int8, span_reduce)

out_path, spec = sys.argv[1], eval(sys.argv[2])
W = 8
mesh = make_mesh((W,), ("data",))
mesh2 = make_mesh((2, 4), ("pod", "data"))
res = {}

ring = jax.jit(shard_map(lambda v: ring_allreduce_int8(v, "data", W),
                         mesh=mesh, in_specs=P("data"), out_specs=P("data")))
x = np.arange(W * 64, dtype=np.float32).reshape(W, 64) / np.float32(100.0) \
    - np.float32(2.0)
cases = {"arange": x}
rng = np.random.RandomState(0)
for i, (n, mag) in enumerate(spec["ring"]):
    cases[f"r{i}"] = (rng.randn(W, n) * mag).astype(np.float32)
for k, v in cases.items():
    res[f"ring_in/{k}"] = v
    res[f"ring_out/{k}"] = np.asarray(ring(jnp.asarray(v.reshape(-1)))
                                      ).reshape(W, -1)

grads = {k: (rng.randn(W, *s) * 10.0 ** rng.uniform(-2, 2)).astype(
    np.float32) for k, s in spec["grads"].items()}
for k, v in grads.items():
    res[f"grads_in/{k}"] = v
gspec = {k: P("data") for k in grads}
for tag, pol in spec["policies"].items():
    pol = RegCSyncPolicy(**pol)
    for sizes in (True, False) if tag == "object" else (True,):
        f = jax.jit(shard_map(
            lambda g: barrier_sync_grads(
                {k: a[0] for k, a in g.items()}, ("data",), pol,
                axis_sizes={"data": W} if sizes else None),
            mesh=mesh, in_specs=(gspec,),
            out_specs={k: P("data") for k in grads}))
        out = f({k: jnp.asarray(v)[:, None] for k, v in grads.items()})
        name = tag if sizes else "object_nosizes"
        for k, v in out.items():
            res[f"sync/{name}/{k}"] = np.asarray(v).reshape(W, *spec["grads"][k])

vals = (np.arange(W, dtype=np.float32) * np.float32(1.5) - np.float32(3.1))
res["span_in"] = vals
for op in ("sum", "mean", "max"):
    f = jax.jit(shard_map(lambda v: span_reduce(v, ("data",), op), mesh=mesh,
                          in_specs=P("data"), out_specs=P("data")))
    res[f"span/{op}"] = np.asarray(f(jnp.asarray(vals)))

axes2 = ("pod", "data")
gspec2 = {k: P(axes2) for k in grads}
for tag in spec["pod_policies"]:
    pol = RegCSyncPolicy(**spec["policies"][tag])
    f = jax.jit(shard_map(
        lambda g: barrier_sync_grads({k: a[0] for k, a in g.items()}, axes2,
                                     pol, axis_sizes={"pod": 2, "data": 4}),
        mesh=mesh2, in_specs=(gspec2,),
        out_specs={k: P(axes2) for k in grads}))
    out = f({k: jnp.asarray(v)[:, None] for k, v in grads.items()})
    for k, v in out.items():
        res[f"pod/{tag}/{k}"] = np.asarray(v).reshape(W, *spec["grads"][k])
np.savez(out_path, **res)
print("REF_OK")
"""


def _policy_kwargs(p):
    return {"ordinary_sync": p.ordinary_sync, "granularity": p.granularity,
            "bucket_bytes": p.bucket_bytes, "compression": p.compression}


def run_reference(script: str, out: Path, spec) -> dict:
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script, str(out), repr(spec)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _counts():
    return {"ar": (P.COLLECTIVE_BYTES["all-reduce"],
                   P.COLLECTIVE_MSGS["all-reduce"]),
            "cp": (P.COLLECTIVE_BYTES["collective-permute"],
                   P.COLLECTIVE_MSGS["collective-permute"])}


def sync_rank(ref_path: str, ring_keys, policies):
    """One rank's side: the reference's inputs, this rank's rows."""
    import torch.distributed as dist
    r = dist.get_rank()
    with np.load(ref_path) as z:
        ref = dict(z)
    mesh = Mesh((WORLD,), ("data",))
    mesh2 = Mesh((2, 4), ("pod", "data"))
    out = {}
    for k in ring_keys:
        P.reset_collectives()
        x = torch.from_numpy(ref[f"ring_in/{k}"][r])
        kept = x.clone()
        out[f"ring/{k}"] = P.ring_allreduce_int8(x, "data", WORLD,
                                                 mesh=mesh).numpy()
        assert torch.equal(x, kept)
        out[f"count/ring/{k}"] = _counts()
    grads = {k[len("grads_in/"):]: torch.from_numpy(v[r])
             for k, v in ref.items() if k.startswith("grads_in/")}
    for tag, pol in policies.items():
        for sizes in (True, False) if tag == "object" else (True,):
            P.reset_collectives()
            got = P.barrier_sync_grads(
                grads, ("data",), P.RegCSyncPolicy(**pol),
                axis_sizes={"data": WORLD} if sizes else None, mesh=mesh)
            name = tag if sizes else "object_nosizes"
            out.update({f"sync/{name}/{k}": v.numpy()
                        for k, v in got.items()})
            out[f"count/sync/{name}"] = _counts()
    for op in ("sum", "mean", "max"):
        P.reset_collectives()
        out[f"span/{op}"] = P.span_reduce(
            torch.from_numpy(ref["span_in"][r:r + 1])[0], ("data",), op,
            mesh=mesh).numpy()
        out[f"count/span/{op}"] = _counts()
    for tag in POD_POLICIES:
        P.reset_collectives()
        got = P.barrier_sync_grads(grads, ("pod", "data"),
                                   P.RegCSyncPolicy(**policies[tag]),
                                   axis_sizes={"pod": 2, "data": 4},
                                   mesh=mesh2)
        out.update({f"pod/{tag}/{k}": v.numpy() for k, v in got.items()})
        out[f"count/pod/{tag}"] = _counts()
    out["pod_index"] = (mesh2.axis_index("pod"), mesh2.axis_index("data"))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("regc_sync")
    pols = {k: _policy_kwargs(p) for k, p in POLICIES.items()}
    ref = run_reference(REF_SCRIPT, tmp / "ref.npz",
                        {"ring": list(RING_SAMPLE),
                         "grads": GRAD_SHAPES, "policies": pols,
                         "pod_policies": list(POD_POLICIES)})
    ring_keys = ["arange"] + [f"r{i}" for i in range(len(RING_SAMPLE))]
    got = spawn_ranks(WORLD, "test_torch_regc_sync:sync_rank",
                      (str(tmp / "ref.npz"), ring_keys, pols),
                      backend="gloo", init_method=f"file://{tmp / 'store'}")
    return ref, got, ring_keys


def _leaf_tol(a, b, tol):
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()), scale)


def _ring_count(n, world=WORLD):
    hops = 2 * (world - 1)
    return {"ar": (0, 0), "cp": (hops * (-(-n // world)) + hops * 4,
                                 2 * hops)}


def test_ring_bit_equal_to_reference(ranks):
    ref, got, keys = ranks
    for k in keys:
        want = ref[f"ring_out/{k}"]
        x = ref[f"ring_in/{k}"].astype(np.float64)
        psum = x.sum(0)
        if k == "arange":       # the reference test's input and bound
            assert (np.abs(want[0] - psum) / (np.abs(psum) + 1e-3)).max() \
                < 0.05
        assert np.abs(want[0] - psum).max() <= 0.1 * np.abs(x).sum(0).max()
        for r in range(WORLD):
            assert got[r][f"ring/{k}"].tobytes() == want[r].tobytes(), (k, r)
            assert got[r][f"ring/{k}"].tobytes() == want[0].tobytes()
            assert got[r][f"count/ring/{k}"] == _ring_count(x.shape[1]), k


def _flats(pol):
    """The sizes of the vectors the policy reduces: one a leaf, or the
    buckets, each closed once it holds ``bucket_bytes``."""
    sizes = [int(np.prod(s)) for s in GRAD_SHAPES.values()]
    if pol.granularity == "object":
        return sizes
    flats, cur = [], 0
    for n in sizes:
        cur += n
        if cur * 4 >= pol.bucket_bytes:
            flats.append(cur)
            cur = 0
    return flats + ([cur] if cur else [])


def _sync_count(tag):
    pol = POLICIES["object" if tag == "object_nosizes" else tag]
    flats = _flats(pol)
    if pol.compression == "int8_ring":
        ring = [_ring_count(n)["cp"] for n in flats]
        return {"ar": (0, 0), "cp": (sum(b for b, _ in ring),
                                     sum(m for _, m in ring))}
    extra = 1 if tag == "object_nosizes" else 0   # the psum of ones
    return {"ar": (4 * sum(flats) + 4 * extra, len(flats) + extra),
            "cp": (0, 0)}


@pytest.mark.parametrize("tag", list(POLICIES) + ["object_nosizes"])
def test_barrier_sync_matches_reference(ranks, tag):
    ref, got, _ = ranks
    pol = POLICIES["object" if tag == "object_nosizes" else tag]
    for k, shape in GRAD_SHAPES.items():
        want = ref[f"sync/{tag}/{k}"]
        for r in range(WORLD):
            a = got[r][f"sync/{tag}/{k}"]
            assert a.shape == shape and a.dtype == np.float32
            assert a.tobytes() == got[0][f"sync/{tag}/{k}"].tobytes()
            if pol.compression == "int8_ring":
                assert a.tobytes() == want[r].tobytes(), (tag, k, r)
            else:
                _leaf_tol(a, want[r], PSUM_TOL)
            assert got[r][f"count/sync/{tag}"] == _sync_count(tag)
    # the psum policies against float64 sums of the inputs
    if pol.compression is None:
        for k in GRAD_SHAPES:
            mean = ref[f"grads_in/{k}"].astype(np.float64).mean(0)
            _leaf_tol(got[0][f"sync/{tag}/{k}"], mean, PSUM_TOL)


def test_object_and_bucket_agree(ranks):
    _, got, _ = ranks
    for k in GRAD_SHAPES:
        for tag in ("bucket128", "bucket4k", "bucket_default"):
            _leaf_tol(got[0][f"sync/{tag}/{k}"], got[0][f"sync/object/{k}"],
                      PSUM_TOL)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_span_reduce_matches_reference(ranks, op):
    ref, got, _ = ranks
    for r in range(WORLD):
        a = got[r][f"span/{op}"]
        assert a.shape == () and a.tobytes() == got[0][f"span/{op}"].tobytes()
        np.testing.assert_allclose(a, ref[f"span/{op}"][r], rtol=1e-6)
        assert got[r][f"count/span/{op}"] == {"ar": (4, 1), "cp": (0, 0)}
    if op == "max":
        assert got[0]["span/max"] == ref["span/max"][0]


@pytest.mark.parametrize("tag", POD_POLICIES)
def test_pod_data_mesh(ranks, tag):
    """(2, 4) over ("pod", "data"): rank r at pod r // 4, data r % 4."""
    ref, got, _ = ranks
    pol = POLICIES[tag]
    for r in range(WORLD):
        assert got[r]["pod_index"] == (r // 4, r % 4)
        for k in GRAD_SHAPES:
            a, want = got[r][f"pod/{tag}/{k}"], ref[f"pod/{tag}/{k}"][r]
            assert a.tobytes() == got[0][f"pod/{tag}/{k}"].tobytes()
            if pol.compression == "int8_ring":
                assert a.tobytes() == want.tobytes(), (tag, k, r)
            else:
                _leaf_tol(a, want, PSUM_TOL)
    flats = _flats(pol)
    if pol.compression == "int8_ring":
        hops = 2 * (4 - 1)
        want_count = {"ar": (4 * sum(flats), len(flats)),
                      "cp": (sum(hops * -(-n // 4) + hops * 4 for n in flats),
                             2 * hops * len(flats))}
    else:
        want_count = {"ar": (4 * sum(flats), len(flats)), "cp": (0, 0)}
    for r in range(WORLD):
        assert got[r][f"count/pod/{tag}"] == want_count
