"""The Triton chain kernel (ops/chain_triton.py) against the lax.scan,
through the Pallas interpreter on the CPU, plus the pieces around it: the
host-built log table, the per-platform choice of chain DP, the CLI's
engine choice, the compile-cache directory and the native library build.
The compiled kernel is compared on the card by the `gpu` test below and
by chip_smoke.py's phase f."""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from minimap2_rs_tpu.config import ChainParams
from minimap2_rs_tpu.ops.chain_ops import (
    chain_dp_aux_batch,
    chain_dp_batch,
    chain_scalars_from_params,
    half_log2_table,
)
from minimap2_rs_tpu.ops.chain_triton import chain_dp_triton, launch_config


def _anchors(B, A, seed, empty_rows=()):
    """Colinear chains plus noise, (grp, rpos)-sorted, mapper-style
    padding (all fields 0xFFFFFFFF) past each read's anchor count."""
    rng = np.random.default_rng(seed)
    grp = np.full((B, A), 0xFFFFFFFF, np.uint32)
    rpos = np.full((B, A), -1, np.int32)
    qpos = np.full((B, A), -1, np.int32)
    span = np.full((B, A), 255, np.int32)
    for b in range(B):
        if b in empty_rows:
            continue
        n = int(rng.integers(1, A + 1))
        nc = max(1, 3 * n // 4)
        qc = np.sort(rng.integers(0, 6 * n, nc))
        rc = 1000 + qc + rng.integers(-3, 4, nc)
        qn = rng.integers(0, 6 * n, n - nc)
        rn = rng.integers(0, 40 * n, n - nc)
        g = np.concatenate([np.zeros(nc, np.uint32),
                            rng.integers(0, 2, n - nc).astype(np.uint32) << np.uint32(31)])
        rp, qp = np.concatenate([rc, rn]), np.concatenate([qc, qn])
        o = np.lexsort((qp, rp, g))
        grp[b, :n], rpos[b, :n], qpos[b, :n], span[b, :n] = g[o], rp[o], qp[o], 15
    return tuple(map(jnp.asarray, (grp, rpos, qpos, span)))


@pytest.mark.parametrize(
    "B,A,window",
    [
        (6, 128, 128),   # full window, 64-wide chunks
        (5, 200, 200),   # A not a multiple of the chunk
        (4, 256, 48),    # truncated window shorter than a chunk
        (3, 96, 1),      # window of one
        (3, 640, 300),   # truncated window, 256-wide chunks
        (2, 520, 520),   # full window, 256-wide chunks, ragged tail
    ],
)
@pytest.mark.parametrize("aux", [False, True])
def test_kernel_matches_scan(B, A, window, aux):
    args = _anchors(B, A, seed=B * A + window, empty_rows=(1,))
    scal = chain_scalars_from_params(ChainParams.defaults_for_k(15))
    ref = (chain_dp_aux_batch if aux else chain_dp_batch)(*args, scal, window)
    got = chain_dp_triton(*args, scal, window, aux=aux, interpret=True)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert g.shape == (B, A) and g.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


def test_kernel_padding_rows_are_base_case():
    """Rows past a read's last anchor, which the up-front padding pass
    writes: f = span, cnt = 1, sq/sr = own coordinates, prev = -1."""
    args = _anchors(4, 200, seed=3, empty_rows=(2,))
    scal = chain_scalars_from_params(ChainParams.defaults_for_k(15))
    f, cnt, sq, sr = map(np.asarray, chain_dp_triton(
        *args, scal, 200, aux=True, interpret=True))
    _, prev = map(np.asarray, chain_dp_triton(
        *args, scal, 200, aux=False, interpret=True))
    grp, rpos, qpos, span = map(np.asarray, args)
    pad = grp == 0xFFFFFFFF
    assert pad.any()
    np.testing.assert_array_equal(f[pad], span[pad])
    assert (cnt[pad] == 1).all() and (prev[pad] == -1).all()
    np.testing.assert_array_equal(sq[pad], qpos[pad])
    np.testing.assert_array_equal(sr[pad], rpos[pad])


def test_launch_config_shapes():
    """64-wide chunks for windows up to 256 and 256-wide chunks beyond
    (the configs measured best on the H100); power-of-two tiles."""
    assert launch_config(256) == (64, 2)
    assert launch_config(1024) == (256, 4)
    for H in (1, 48, 256, 257, 5000):
        ch, nw = launch_config(H)
        assert ch & (ch - 1) == 0 and nw in (1, 2, 4, 8)


def test_half_log2_table_is_the_oracles():
    from minimap2_rs_tpu.oracle.lchain import mg_log2

    tab = half_log2_table(20001)
    assert tab.dtype == np.float32 and tab[0] == 0
    for dd in (1, 2, 3, 7, 100, 499, 500, 4999, 20000):
        assert tab[dd] == np.float32(0.5) * mg_log2(dd + 1)
    scal = chain_scalars_from_params(ChainParams.defaults_for_k(15))
    wide = chain_scalars_from_params(ChainParams.defaults_for_k(15, bw=20000))
    # both bands share one table shape, hence one compiled program
    assert scal.half_log2.shape == wide.half_log2.shape == (20001,)


@pytest.mark.parametrize("platform,kernel", [("gpu", True), ("cpu", False)])
def test_chain_dp_selected_by_platform(monkeypatch, platform, kernel):
    from minimap2_rs_tpu.models import mapper

    monkeypatch.setattr(mapper.jax, "default_backend", lambda: platform)
    assert mapper._use_pallas_chain() is kernel


def test_chain_dp_refuses_other_platforms(monkeypatch):
    from minimap2_rs_tpu.models import mapper

    monkeypatch.setattr(mapper.jax, "default_backend", lambda: "tpu")
    with pytest.raises(NotImplementedError):
        mapper._use_pallas_chain()


def test_auto_engine_does_not_swallow_device_errors(monkeypatch):
    from minimap2_rs_tpu import cli

    assert cli._auto_engine() == "host"  # CPU-only JAX

    def broken():
        raise RuntimeError("CUDA plugin failed to initialise")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="CUDA plugin"):
        cli._auto_engine()


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_directory(monkeypatch, tmp_path, env_set):
    from minimap2_rs_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", "untouched")
            assert compile_cache.configure() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == "untouched"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.configure()
            assert path == compile_cache.CHECKOUT_DIR
            assert jax.config.jax_compilation_cache_dir == path
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert path == os.path.join(repo, ".jax_cache")
            with open(os.path.join(repo, ".gitignore")) as f:
                assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_build_is_atomic_under_concurrency(tmp_path):
    """Concurrent first-use builds serialize on the lock, leave one
    complete library and no temporaries."""
    (tmp_path / "Makefile").write_text(
        "OUT ?= lib.so\nall: $(OUT)\n$(OUT): src.cpp\n\tsleep 0.2; cp src.cpp $(OUT)\n"
    )
    (tmp_path / "src.cpp").write_text("payload\n")
    so, src = str(tmp_path / "lib.so"), str(tmp_path / "src.cpp")
    code = (
        "from minimap2_rs_tpu.runtime.host import _build; "
        f"_build({so!r}, {src!r})"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=repo) for _ in range(4)]
    assert all(p.wait(timeout=60) == 0 for p in procs)
    assert (tmp_path / "lib.so").read_text() == "payload\n"
    assert sorted(os.listdir(tmp_path)) == [".build.lock", "Makefile", "lib.so", "src.cpp"]


@pytest.mark.gpu
def test_compiled_kernel_matches_scan_on_gpu(gpu):
    args = _anchors(64, 1024, seed=5)
    scal = chain_scalars_from_params(ChainParams.defaults_for_k(15))
    for window in (1024, 256):
        for aux, scan in ((False, chain_dp_batch), (True, chain_dp_aux_batch)):
            ref = scan(*args, scal, window)
            got = chain_dp_triton(*args, scal, window, aux=aux)
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(np.asarray(r), np.asarray(g))
