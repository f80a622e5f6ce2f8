"""The port's data sources and pipeline (``repro_torch.data``) against the
reference.

The token streams are a pure function of (seed, step, rank, world) in
numpy on both sides, so they are compared bit for bit; a corpus file
written by either package's ``write_token_file`` is read by the other.
The prefetcher keeps the reference's order, ``at()`` jump and
``close()``, and hands out tensors on the device it was asked for."""
import threading

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro.data import sources as RS  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro_torch.data import (  # noqa: E402
    DataConfig, MemmapTokens, Prefetcher, SyntheticTokens, make_pipeline,
    write_token_file,
)
from repro_torch.data import sources as S  # noqa: E402

POINTS = [(step, rank, world) for step in (0, 3, 17)
          for rank, world in ((0, 1), (1, 2), (3, 4))]


def _equal(got, want):
    assert set(got) == set(want) == {"tokens", "targets"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_hash64_matches_reference():
    x = np.arange(0, 1 << 20, 4099, dtype=np.uint64) * np.uint64(7919)
    np.testing.assert_array_equal(S._hash64(x.copy()), RS._hash64(x.copy()))


@pytest.mark.parametrize("step,rank,world", POINTS)
def test_synthetic_tokens_bit_equal(step, rank, world):
    for vocab, seq, gb, seed in ((97, 16, 8, 3), (92544, 33, 4, 0)):
        got = SyntheticTokens(vocab, seq, gb, seed).batch_at(
            step, rank=rank, world=world)
        want = RS.SyntheticTokens(vocab, seq, gb, seed).batch_at(
            step, rank=rank, world=world)
        _equal(got, want)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A corpus written by each package (lengths that make windows wrap)."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 1 << 31, 1001).astype(np.uint32)
    write_token_file(d / "port.bin", toks)
    RS.write_token_file(d / "ref.bin", toks)
    return d, toks


def test_token_files_cross_read(corpora):
    d, toks = corpora
    for name in ("port.bin", "ref.bin"):
        assert (d / name).read_bytes() == toks.tobytes()
        assert (d / (name + ".meta")).read_text() == (
            d / "ref.bin.meta").read_text()
        np.testing.assert_array_equal(MemmapTokens(d / name, 16, 4)._mm, toks)
        np.testing.assert_array_equal(RS.MemmapTokens(d / name, 16, 4)._mm,
                                      toks)


@pytest.mark.parametrize("step,rank,world", POINTS)
def test_memmap_tokens_bit_equal(corpora, step, rank, world):
    d, _ = corpora
    for name in ("port.bin", "ref.bin"):
        got = MemmapTokens(d / name, 16, 8).batch_at(step, rank=rank,
                                                     world=world)
        want = RS.MemmapTokens(d / "ref.bin", 16, 8).batch_at(
            step, rank=rank, world=world)
        _equal(got, want)


def test_data_config_sources(corpora):
    d, _ = corpora
    for kw in ({}, {"kind": "memmap", "path": str(d / "port.bin"),
                    "seq_len": 16}):
        got = DataConfig(**kw).make_source().batch_at(2)
        _equal(got, RefDataConfig(**kw).make_source().batch_at(2))
    with pytest.raises(ValueError):
        DataConfig(kind="parquet").make_source()


def test_prefetcher_orders_and_jumps():
    cfg = DataConfig(kind="synthetic", vocab_size=11, seq_len=4,
                     global_batch=2)
    src = cfg.make_source()
    pipe = make_pipeline(cfg, start_step=3, device="cpu")
    try:
        s0, b0 = next(pipe)
        s1, b1 = next(pipe)
        assert (s0, s1) == (3, 4)
        for s, b in ((s0, b0), (s1, b1)):
            assert isinstance(b["tokens"], torch.Tensor)
            assert b["tokens"].dtype == torch.int32
            assert b["tokens"].device.type == "cpu"
            _equal({k: v.numpy() for k, v in b.items()}, src.batch_at(s))
        # jump (restart): the stream resumes exactly at the requested step
        assert pipe.at(100) is pipe
        for want in (100, 101, 102):
            s, b = next(pipe)
            assert s == want
            _equal({k: v.numpy() for k, v in b.items()}, src.batch_at(s))
    finally:
        pipe.close()
    pipe._thread.join(timeout=5)
    assert not pipe._thread.is_alive()


def test_prefetcher_rank_world_and_put_fn_thread():
    """put_fn runs on the caller's thread, never on the prefetch thread;
    rank and world shard the stream as the source does."""
    src = SyntheticTokens(53, 8, 4)
    seen = []

    def put(batch):
        seen.append(threading.current_thread())
        return batch
    pipe = Prefetcher(src, start_step=5, rank=1, world=2, put_fn=put)
    try:
        for want in (5, 6):
            s, b = next(pipe)
            assert s == want
            _equal(b, src.batch_at(want, rank=1, world=2))
    finally:
        pipe.close()
    assert seen == [threading.main_thread()] * 2
