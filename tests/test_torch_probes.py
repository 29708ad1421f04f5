"""The probes' plain versions (what their wrappers run on CPU tensors)
against the reference's Pallas probes in ``experiments/``, on the CPU.

* K1's probe modes (``arrival_probe_cuda``): every mode of
  ``round14_kernel_diet.make_kernel`` through ``pl.pallas_call(...,
  interpret=True)``, and ``round16_bf16leaf_probe``'s patched production
  kernel (``arrival_step16_pallas`` with ``pa._f16_bits_to_f32`` set to the
  probe's ``_bf16_style_decode``).  Integers equal; floats within rtol
  1e-5 on >= 99.5% of elements (XLA:CPU contracts FMAs, PyTorch does not).
* ``round18_bf16_shade_probe.kernel``, ``round18_vmem_tree_probe.kernel``
  and ``round20_tile3d_probe.k1d`` in interpret mode.
* The kernels of ``round2_probe.py`` and ``round18_mosaic_probe.py`` are
  nested inside functions; each is held against its jnp expression,
  reproduced here with the probe's file:line.

Importing a probe switches JAX's compilation cache settings
(``jax.config.update`` at its top); the ``probes`` fixture restores them.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from unity_webgpu_pathtracer_torch.experiments import round2_probe as port_round2
from unity_webgpu_pathtracer_torch.experiments import round18_mosaic_probe as port_mosaic
from unity_webgpu_pathtracer_torch.ops import cuda_probes as cp
from unity_webgpu_pathtracer_torch.ops.cuda_arrival import DIET_MODES, arrival_probe_cuda
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import FULL, Wide16State
from unity_webgpu_pathtracer_torch.utils import math as umath
from unity_webgpu_pathtracer_tpu.ops import pallas_arrival as pa
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as jtw

torch.set_num_threads(2)

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "experiments")
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
B, DEPTH = 1024, 11
INT_FIELDS = ("ptr", "pend", "sp", "tri", "found", "stack_row", "stack_mask")


@pytest.fixture(scope="module")
def probes():
    """The probe modules with a Pallas kernel at module level, imported
    from their files; JAX's cache settings restored afterwards."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    mods = {}
    try:
        for name in ("round14_kernel_diet", "round16_bf16leaf_probe", "round18_bf16_shade_probe",
                     "round18_vmem_tree_probe", "round20_tile3d_probe"):
            spec = importlib.util.spec_from_file_location(
                f"_probe_{name}", os.path.join(EXPERIMENTS, f"{name}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mods


def _fix_exp31(words: np.ndarray) -> None:
    """Clear bit 14 of every halfword whose exponent field is 31, in place.
    The reference's decode (``pallas_arrival.py:62-82``) is exact only on
    builder-contract values: on an exponent-31 halfword it gives a 2^16-ish
    number where the hardware gives inf or NaN."""
    h = words.view(np.uint16)
    h[(h & 0x7C00) == 0x7C00] &= np.uint16(0xBFFF)


def _k1_inputs(seed=3):
    """Rows mixing inner rows (word 3 = 0: quantized boxes that rays hit),
    leaf rows (word 3 = 1-16: f16 triangles near the anchor) and rows of
    random bits (word 3 random: leaves of 16 or neither), so every section
    runs; a state with dead lanes, fresh and partial pend masks and
    half-full stacks."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(B, 96)).astype(np.float32)
    ri = rows.view(np.int32)
    kind = rng.integers(0, 3, B)
    inner, leaf = kind == 0, kind == 1
    ni, nl = int(inner.sum()), int(leaf.sum())
    ri[leaf, 4:76] = (rng.normal(size=(nl, 144)) * 0.5).astype(np.float16).view(np.int32)
    ri[leaf, 3] = rng.integers(1, 17, nl)
    ri[leaf, 76:92] = rng.integers(0, 10**6, (nl, 16))
    _fix_exp31(ri[:, 4:76])
    ri[inner, 3] = 0
    e = rng.integers(121, 126, (ni, 3))
    ri[inner, 4] = e[:, 0] | (e[:, 1] << 8) | (e[:, 2] << 16)
    ri[inner, 32:48] = rng.integers(-1, B, (ni, 16))
    o = rng.normal(size=(3, B)).astype(np.float32)
    d = rng.normal(size=(3, B)).astype(np.float32)
    inv = (1.0 / d).astype(np.float32)
    ptr = rng.integers(0, B, B).astype(np.int32)
    ptr[rng.random(B) < 0.1] = -1
    active = rng.random(B) < 0.95
    state = dict(
        ptr=ptr, pend=np.where(rng.random(B) < 0.5, FULL, rng.integers(0, 1 << 16, B)),
        sp=rng.integers(0, DEPTH - 2, B),
        stack_row=rng.integers(0, B, (DEPTH, B)),
        stack_mask=np.where(rng.random((DEPTH, B)) < 0.3, 0, rng.integers(1, 1 << 16, (DEPTH, B))),
        t=np.where(rng.random(B) < 0.5, 1e5, rng.uniform(0.5, 30.0, B)),
        u=rng.uniform(size=B), v=rng.uniform(size=B), tri=rng.integers(0, 10**6, B),
        found=rng.random(B) < 0.2)
    state = {k: v.astype(np.float32 if k in "tuv" else (bool if k == "found" else np.int32))
             for k, v in state.items()}
    return rows, o, d, inv, state, active


def _torch_state(st) -> Wide16State:
    z3 = torch.zeros((3, B))
    neg = torch.full((B,), -1, dtype=torch.int32)
    return Wide16State(**{k: torch.from_numpy(v.copy()) for k, v in st.items()},
                       inst=neg, hit_inst=neg.clone(), sp_enter=torch.zeros_like(neg),
                       local_o=z3, local_d=z3.clone(), local_inv=z3.clone())


def _port_probe(rows, o, d, inv, st, active, rowidx, mode) -> dict:
    out = arrival_probe_cuda(torch.from_numpy(rows), torch.from_numpy(rowidx),
                             torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(inv),
                             _torch_state(st), torch.from_numpy(active), mode)
    return {k: getattr(out, k).numpy() for k in st}


def _assert_k1(got: dict, want: dict, what: str, int_share: float = 1.0) -> None:
    for k in INT_FIELDS:
        same = got[k] == np.asarray(want[k]).astype(got[k].dtype)
        assert same.mean() >= int_share, f"{what}.{k}: {same.mean()}"
    for k in ("t", "u", "v"):
        close = np.isclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=0.0, equal_nan=True)
        assert close.mean() >= 0.995, f"{what}.{k}: {close.mean()}"


def _diet_pallas(mod, mode, rows, o, d, inv, st, active):
    """make_kernel(mode) as round14_kernel_diet.py:235-261 calls it, one
    block of B lanes, on the rows the arrival wrapper would gather."""
    live = (st["ptr"] >= 0) & active
    rows_t = rows[np.where(live, np.arange(B), 0)].T.copy()

    def col():
        return pl.BlockSpec((B,), lambda i: (i,), memory_space=pltpu.VMEM)

    def plane(r):
        return pl.BlockSpec((r, B), lambda i: (0, i), memory_space=pltpu.VMEM)

    def cshape(dt=jnp.int32):
        return jax.ShapeDtypeStruct((B,), dt)

    out_shapes = [cshape(), cshape(), cshape(), cshape(jnp.float32), cshape(jnp.float32),
                  cshape(jnp.float32), cshape(), cshape(),
                  jax.ShapeDtypeStruct((DEPTH, B), jnp.int32),
                  jax.ShapeDtypeStruct((DEPTH, B), jnp.int32)]
    call = pl.pallas_call(mod.make_kernel(mode), grid=(1,),
                          in_specs=[plane(96), plane(3), plane(3), plane(3), col()]
                          + [col()] * 8 + [plane(DEPTH)] * 2,
                          out_specs=[col()] * 8 + [plane(DEPTH)] * 2,
                          out_shape=out_shapes, interpret=True)
    outs = call(rows_t, o, d, inv, live.astype(np.int32), st["ptr"], st["pend"], st["sp"],
                st["t"], st["u"], st["v"], st["tri"], st["found"].astype(np.int32),
                st["stack_row"], st["stack_mask"])
    names = ("ptr", "pend", "sp", "t", "u", "v", "tri", "found", "stack_row", "stack_mask")
    return dict(zip(names, (np.asarray(x) for x in outs)))


@pytest.mark.parametrize("mode", DIET_MODES)
def test_kernel_diet_modes_match_pallas(probes, mode):
    """Each stub of the kernel diet computes what the diet's stub does,
    on every lane (inner, leaf, other and dead ones)."""
    rows, o, d, inv, st, active = _k1_inputs()
    want = _diet_pallas(probes["round14_kernel_diet"], mode, rows, o, d, inv, st, active)
    got = _port_probe(rows, o, d, inv, st, active, np.arange(B, dtype=np.int32), mode)
    _assert_k1(got, want, mode)
    assert got["found"].sum() > st["found"].sum()        # some lane hit a triangle
    if mode != "no_stack":
        assert (got["sp"] > st["sp"]).any()              # some lane pushed


def _pallas_step(rows, o, d, inv, st, active) -> dict:
    js = jtw.init_state16(B, jnp.float32(1e5), depth=DEPTH)._replace(
        **{k: jnp.asarray(v) for k, v in st.items()})
    out = pa.arrival_step16_pallas(jnp.asarray(rows), jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(inv), js, jnp.asarray(active), interpret=True)
    return {k: np.asarray(getattr(out, k)) for k in st}


def test_bf16leaf_matches_patched_production_kernel(probes, monkeypatch):
    """``f16leaf`` is the production kernel on the row plane (here the
    state's ptr), ``bf16leaf`` the same with round16_bf16leaf_probe.py's
    decode patched in (:45-51).  Integers equal (bf16leaf: on >= 99.5% of
    lanes), floats as above."""
    rows, o, d, inv, st, active = _k1_inputs(seed=5)
    plain = _pallas_step(rows, o, d, inv, st, active)
    _assert_k1(_port_probe(rows, o, d, inv, st, active, st["ptr"], "f16leaf"), plain, "f16leaf")
    monkeypatch.setattr(pa, "_f16_bits_to_f32", probes["round16_bf16leaf_probe"]._bf16_style_decode)
    patched = _pallas_step(rows, o, d, inv, st, active)
    assert any(not np.array_equal(patched[k], plain[k]) for k in st), "the patch did not take"
    # bf16-decoded f16 bits make near-equal triangles: an FMA can flip the
    # closest of two (one lane in 1,024 here), as in test_torch_arrival.py.
    _assert_k1(_port_probe(rows, o, d, inv, st, active, st["ptr"], "bf16leaf"), patched,
               "bf16leaf", int_share=0.995)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lobe_chain_matches_pallas(probes, monkeypatch, dtype):
    """round18_bf16_shade_probe.kernel (:62-72) in interpret mode, with 8
    repeats of the chain in place of its 64 (``R``, read when the kernel
    is traced; XLA's compile time grows steeply with the unrolled chain).
    XLA contracts FMAs and rounds bf16 chains elsewhere than PyTorch, and
    the chain's divisions grow those steps: f32 within rtol 1e-3 on >=
    99.5% of lanes, bf16 within rtol 2^-7 on >= 99%."""
    mod = probes["round18_bf16_shade_probe"]
    monkeypatch.setattr(mod, "R", 8)
    x = np.random.default_rng(0).uniform(0.05, 0.95, 2048).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(pl.pallas_call(
        functools.partial(mod.kernel, jdt), out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(x))
    got = cp.lobe_chain_plain(torch.from_numpy(x), getattr(torch, dtype), repeats=8).numpy()
    rtol, share = (1e-3, 0.995) if dtype == "float32" else (2.0 ** -7, 0.99)
    assert np.isfinite(got).all()
    assert np.isclose(got, want, rtol=rtol, atol=0.0).mean() >= share


def _tree_pallas(mod, idx, table):
    """round18_vmem_tree_probe.kernel (:47-53) in interpret mode over
    len(idx) lanes (a multiple of its BLK)."""
    return np.asarray(pl.pallas_call(
        mod.kernel, grid=(idx.shape[0] // mod.BLK,),
        in_specs=[pl.BlockSpec((mod.BLK,), lambda i: (i,), memory_space=pltpu.VMEM),
                  pl.BlockSpec((mod.ROWS, mod.COLS), lambda i: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((mod.BLK, mod.COLS), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((idx.shape[0], mod.COLS), jnp.float32),
        interpret=True)(idx, jnp.asarray(table).astype(jnp.bfloat16)))


def test_cluster_gather_matches_pallas(probes):
    """round18_vmem_tree_probe.kernel (:47-53): the one-hot product of a
    bf16 table is exact, as is the port's widening gather (P7,
    ``tree_gather``)."""
    mod = probes["round18_vmem_tree_probe"]
    idx = np.random.default_rng(0).integers(0, mod.ROWS, 2 * mod.BLK).astype(np.int32)
    table = np.random.default_rng(1).uniform(size=(mod.ROWS, mod.COLS)).astype(np.float32)
    got = cp.tree_gather(torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), _tree_pallas(mod, idx, table))


def test_tree_gather_outside_indices_match_pallas(probes):
    """An index outside [0, 4096) matches no row of the one-hot product, so
    the reference gives a row of zeros; so does P7's plain version (not a
    wrapped or refused index), at -1, 4096, 2^31 - 1 and -2^31."""
    mod = probes["round18_vmem_tree_probe"]
    idx = np.random.default_rng(2).integers(0, mod.ROWS, mod.BLK).astype(np.int32)
    outside = np.array([-1, mod.ROWS, 2**31 - 1, -(2**31)], dtype=np.int32)
    idx[::9] = np.resize(outside, idx[::9].shape)
    table = np.random.default_rng(3).uniform(size=(mod.ROWS, mod.COLS)).astype(np.float32)
    want = _tree_pallas(mod, idx, table)
    got = cp.tree_gather(torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[::9].any() and want[1::9].all()
    from unity_webgpu_pathtracer_torch.experiments import round18_vmem_tree_probe as port

    odd = port.with_outside(torch.from_numpy(idx[1::9].copy()))
    assert set(odd[::7].tolist()) == set(outside.tolist())


def test_step_chain_matches_pallas(probes):
    """round20_tile3d_probe.k1d (:39-46) on (B,) blocks of 1024: within
    rtol 1e-5 (XLA fuses multiply-adds: up to ~60 ulps over 32 steps)."""
    mod = probes["round20_tile3d_probe"]
    x = np.arange(4096, dtype=np.float32)
    spec = pl.BlockSpec((1024,), lambda i: (i,))
    want = pl.pallas_call(mod.k1d, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                          grid=(4,), in_specs=[spec], out_specs=spec, interpret=True)(x)
    got = cp.step_chain(torch.from_numpy(x).reshape(4, 8, 128)).reshape(-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("chunk", [1, 5, 15, 16, 17, 33, 1000, 1024, 2112, 2113, 8192, 8449,
                                   20000, 135_168])
def test_ring_gather_matches_probe(chunk):
    """round2_probe.py:80-81 (inputs) and :83-116 (a 16-slot ring: copy k
    lands in slot k % 16; out is the ring's column sum): fewer rows than
    slots, about one and two rings, the probe's chunks, and chunks at and
    past the kernel's slicing edges on 132 SMs (16 k a block on every SM,
    1,024 k a block on every SM)."""
    n, w = 300, cp.RING_W
    jtable = jnp.arange(n * w, dtype=jnp.float32).reshape(n, w) % 7.0
    jidx = (jnp.arange(chunk, dtype=jnp.int32) * np.int32(-1640531527)) % n
    table = port_round2.table(n, w, "cpu")
    idx = torch.from_numpy(port_round2.hashed_idx(chunk, n))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    ring = np.zeros((cp.RING_SLOTS, w), np.float32)
    jt, ji = np.asarray(jtable), np.asarray(jidx)
    for k in range(chunk):
        ring[k % cp.RING_SLOTS] = jt[ji[k]]
    want = np.asarray(jnp.sum(jnp.asarray(ring), axis=0, keepdims=True))
    np.testing.assert_array_equal(cp.ring_gather(table, idx).numpy(), want)


def test_ring_gather_refuses_misaligned_table():
    """A contiguous (n, 128) view one float into its storage: the bulk
    copies need 16-byte sources, so the wrapper refuses it on either
    device (the kernel would fault)."""
    flat = torch.zeros(10 * cp.RING_W + 4)
    table = flat[1:1 + 10 * cp.RING_W].view(10, cp.RING_W)
    assert table.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        cp.ring_gather(table, torch.zeros(4, dtype=torch.int32))
    cp.ring_gather(flat[4:].view(10, cp.RING_W), torch.zeros(4, dtype=torch.int32))


def test_cumsum_refuses_misaligned_input():
    """The scan loads 16-byte vectors: an int32 view one element in is
    refused on either device."""
    flat = torch.arange(101, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte"):
        cp.intrinsic("cumsum_i32", flat[1:])
    assert torch.equal(cp.intrinsic("cumsum_i32", flat[4:]), torch.cumsum(flat[4:], 0))


@pytest.mark.parametrize("n", [1, 1025, 98_303, 98_304])
def test_cumsum_plain_matches_jnp(n):
    """round18_mosaic_probe.py:102-105 (``jnp.cumsum`` of int32): the scan's
    plain version exactly, at ragged sizes and the pool's 98,304, on int32
    inputs with negatives."""
    a = np.random.default_rng(n).integers(-1000, 1000, n).astype(np.int32)
    want = np.asarray(jnp.cumsum(jnp.asarray(a)))
    assert want.dtype == np.int32
    np.testing.assert_array_equal(cp.intrinsic("cumsum_i32", torch.from_numpy(a)).numpy(), want)


@pytest.mark.parametrize("on_chip", [True, False])
def test_table_sum_matches_probe(on_chip):
    """round2_probe.py:166-174: sum_k table[idx[k]][0] by fori_loop; exact
    (the table holds integers 0-6)."""
    n, chunk = 1024 if on_chip else 4000, 4096
    jtable = jnp.arange(n * cp.TABLE_W, dtype=jnp.float32).reshape(n, cp.TABLE_W) % 7.0
    jidx = (jnp.arange(chunk, dtype=jnp.int32) * np.int32(-1640531527)) % n
    want = jax.lax.fori_loop(0, chunk, lambda k, acc: acc + jtable[jidx[k]][0], jnp.float32(0.0))
    got = cp.table_sum(port_round2.table(n, cp.TABLE_W, "cpu"),
                       torch.from_numpy(port_round2.hashed_idx(chunk, n)), on_chip)
    assert float(got[0, 0]) == float(want)


@pytest.mark.parametrize("n", [1024, 4000])
def test_table_sum_library_matches_probe(n):
    """P2's library call (``round2_probe.table_sum_library``, one
    ``embedding_bag`` over the column view) against the probe's fori_loop
    sum (round2_probe.py:166-174), exactly."""
    chunk = 4096
    jtable = jnp.arange(n * cp.TABLE_W, dtype=jnp.float32).reshape(n, cp.TABLE_W) % 7.0
    jidx = (jnp.arange(chunk, dtype=jnp.int32) * np.int32(-1640531527)) % n
    want = jax.lax.fori_loop(0, chunk, lambda k, acc: acc + jtable[jidx[k]][0], jnp.float32(0.0))
    li = torch.from_numpy(port_round2.hashed_idx(chunk, n)).long()
    got = port_round2.table_sum_library(port_round2.table(n, cp.TABLE_W, "cpu"), li,
                                        torch.zeros(1, dtype=torch.long))
    assert got.shape == (1, 1) and float(got[0, 0]) == float(want)


@pytest.mark.parametrize("n_idx,plan", [(0, (1, 1)), (1, (1, 1)), (4095, (32, 1)),
                                         (4096, (32, 1)), (4097, (33, 1)), (20_000, (157, 1)),
                                         (131_072, (1024, 1)), (131_073, (513, 2))])
def test_table_plan_pinned(n_idx, plan):
    """P2 in device memory: blocks of 128 threads, one index a thread a
    round, 32 blocks at the probe's 4,096; past 1,024 blocks, more rounds a
    block."""
    assert cp.table_plan(n_idx) == plan


@pytest.mark.parametrize("rows,plan", [(128, (8, 16)), (256, (8, 32)), (512, (8, 64)),
                                       (1024, (8, 128)), (1000, (8, 125)), (1, (8, 1)),
                                       (9640, (8, 1205)), (9641, (16, 603)),
                                       (10_416, (16, 651)), (19_280, (16, 1205))])
def test_table_cluster_plan_pinned(rows, plan):
    """P2 on chip: the probe's 24-192 KB tables on a cluster of 8 blocks
    (24 KB a block at 192 KB), the 2 MB table (10,416 rows) on 16, ragged
    row counts rounded up a rank, each rank within TABLE_SMEM bytes."""
    c, per = cp.table_cluster_plan(rows)
    assert (c, per) == plan
    assert c * per >= rows and per * cp.TABLE_W * 4 <= cp.TABLE_SMEM


def test_table_sum_refuses_above_cluster_capacity():
    """On the CPU too: a table of more rows than a cluster of 16 holds is
    refused on chip and summed from device memory; one at the capacity is
    taken; an on-chip table off a 16-byte boundary is refused."""
    idx = torch.tensor([0, 5, 19_279], dtype=torch.int32)
    fits = port_round2.table(cp.TABLE_ROWS_MAX, cp.TABLE_W, "cpu")
    assert torch.equal(cp.table_sum(fits, idx, True), cp.table_sum_plain(fits, idx))
    big = port_round2.table(cp.TABLE_ROWS_MAX + 1, cp.TABLE_W, "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        cp.table_sum(big, idx, True)
    assert torch.equal(cp.table_sum(big, idx, False), cp.table_sum_plain(big, idx))
    off = torch.zeros(64 * cp.TABLE_W + 1)[1:].view(64, cp.TABLE_W)
    with pytest.raises(ValueError, match="16-byte"):
        cp.table_sum(off, idx[:2], True)
    assert float(cp.table_sum(off, idx[:2], False)) == 0.0


def _bits(x: float) -> int:
    return int(np.float32(x).view(np.uint32))


@pytest.mark.parametrize("first,count", [
    (0, 1 << 22),                                # zero, denormals, the smallest normals
    (_bits(0.9) - (1 << 21), 1 << 22),           # around the divisor
    (_bits(1.0), 1 << 22),                       # [1, 2): q of 1 and 2
    (_bits(16.0), 1 << 22),                      # the chain's dividends (< ~25)
    (_bits(2048.0) - (1 << 21), 1 << 22),        # the short form's limit
    (0x7F800000 - (1 << 20), (1 << 20) + (1 << 21)),   # the largest floats, Inf, NaN
])
def test_remainder_plain_matches_fmod(first, count):
    """P3's remainder (csrc/probes.cu ``rem09``, op for op in
    ``rem09_plain``) equals fmod by 0.9f on every bit pattern of each
    range; the card checks all 2^31 (``remainder_check`` on CUDA)."""
    assert cp.remainder_check(first, count, "cpu") == 0


def test_schlick_chain_with_short_remainder_is_plain():
    """The chain with ``rem09_plain`` in place of ``torch.fmod`` gives the
    bits of ``schlick_chain_plain`` on the probe's input and on inputs of
    either sign over 25 binades, zeros, ones and values past 2048: the
    kernel's form computes the plain version's function."""
    def chain(v):
        acc = torch.zeros_like(v)
        for _ in range(cp.SCHLICK_BLOCKS):
            w = 1.0 - v
            w2 = w * w
            f = w2 * w2 * w
            g = umath.sqrt(torch.abs(v * 0.9 + 0.05))
            acc = acc + f * g + v * (1.0 - f)
            v = cp.rem09_plain(torch.abs(acc * 0.3 + 0.1)) + 0.05
        return acc

    rng = np.random.default_rng(12)
    wide = 2.0 ** rng.uniform(-20, 5, 8192) * rng.choice([-1.0, 1.0], 8192)
    for x in (np.linspace(0.1, 0.9, 262144), np.concatenate(
            [wide, [0.0, -0.0, 1.0, -1.0, 2048.0, 3000.0, -1e6, 1e30]])):
        xt = torch.from_numpy(x.astype(np.float32))
        got, want = chain(xt), cp.schlick_chain_plain(xt)
        nan = want.isnan()
        assert torch.equal(got.isnan(), nan)
        assert torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])


def test_scalar_reductions_counts_whole_tensor_reductions():
    """``k2_span.ScalarReductions``, by which phase 13 prices the main
    path's reductions a super-iteration: the ``.sum()`` and ``.any()`` of a
    whole tensor the code calls, not a reduction over a dim (the prestep's
    ``.sum(dim=1)``, ``.any(dim=1)``) nor the sums that ``sum_to_size`` and
    ``mean`` make."""
    from unity_webgpu_pathtracer_torch.experiments import k2_span

    x = torch.rand(64, 16)
    mask = x < 0.5
    with k2_span.ScalarReductions() as red:
        mask.sum(), mask.sum(), torch.minimum(x.sum(), x.max())
        bool((mask.any() | (x.mean() < 0)).item())
        mask.sum(dim=1, dtype=torch.int32), mask.any(dim=1), x.sum_to_size(1, 16)
    assert red.counts == {"sum": 3, "any": 1}


def test_schlick_chain_matches_probe():
    """round2_probe.py:257-268 (the kernel body), op by op in jnp on the
    probe's (2048, 128) lanes: equal within rtol 1e-5 on >= 99.5%."""
    x = np.linspace(0.1, 0.9, 262144).astype(np.float32).reshape(2048, 128)
    v = jnp.asarray(x)
    acc = jnp.zeros_like(v)
    for _ in range(40):
        w = 1.0 - v
        w2 = w * w
        f = w2 * w2 * w
        g = jnp.sqrt(jnp.abs(v * 0.9 + 0.05))
        acc = acc + f * g + v * (1.0 - f)
        v = jnp.abs(acc * 0.3 + 0.1) % 0.9 + 0.05
    got = cp.schlick_chain(torch.from_numpy(x)).numpy()
    assert np.isclose(got, np.asarray(acc), rtol=1e-5, atol=1e-6).mean() >= 0.995


def _pcg_ref(s):
    """round18_mosaic_probe.py:69-73."""
    old = s + jnp.uint32(747796405) + jnp.uint32(2891336453)
    shift = (old >> jnp.uint32(28)) + jnp.uint32(4)
    word = ((old >> shift) ^ old) * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


_JNP = {"sin": jnp.sin, "cos": jnp.cos, "log": jnp.log, "exp": jnp.exp, "sqrt": jnp.sqrt,
        "arccos": jnp.arccos, "arctan": jnp.arctan, "arctan2": jnp.arctan2, "power": jnp.power,
        "cumsum_i32": jnp.cumsum, "pcg_uint32": _pcg_ref,
        # :82
        "u32_to_f32": lambda s: s.astype(jnp.float32) * jnp.float32(1.0 / 4294967295.0)}


@pytest.mark.parametrize("op", cp.INTRINSICS)
def test_intrinsics_match_probe(op):
    """round18_mosaic_probe.py:61-105 at its tolerances: the PCG step and
    cumsum exact, u32 -> f32 exact, the transcendentals within rtol 1e-5,
    atol 1e-6."""
    t = port_mosaic.inputs("cpu", 1024)
    args = port_mosaic.operands(op, t)
    jargs = [jnp.asarray(a.numpy().view(np.uint32)) if a is t["u32"] else jnp.asarray(a.numpy())
             for a in args]
    want = np.asarray(_JNP[op](*jargs))
    got = cp.intrinsic(op, *args).numpy()
    if op == "pcg_uint32":
        got = got.view(np.uint32)
    if op in ("pcg_uint32", "u32_to_f32", "cumsum_i32"):
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sum_scalar_matches_probe():
    """round18_mosaic_probe.py:117: within rtol 1e-5 of jnp.sum."""
    f = port_mosaic.inputs("cpu", 1024)["f"]
    want = float(jnp.sum(jnp.asarray(f.numpy())))
    assert abs(float(cp.sum_scalar(f)[0]) - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("n", [1, 3, 1023, 1025, 98_303, 98_304, 10**6])
def test_sum_scalar_plain_matches_jnp(n):
    """round18_mosaic_probe.py:117 (within rtol 1e-5 of ``jnp.sum``): the
    sum's plain version, which follows the kernel's order, at ragged sizes,
    the pool's 98,304 and 10^6 (245 blocks)."""
    x = np.random.default_rng(n).uniform(0.01, 0.99, n).astype(np.float32)
    want = float(jnp.sum(jnp.asarray(x)))
    got = cp.sum_scalar(torch.from_numpy(x))
    assert got.shape == (1,) and got.dtype == torch.float32
    assert abs(float(got[0]) - want) <= 1e-5 * abs(want)


def _sum_in_kernel_order(x, threads, vec, max_blocks):
    """csrc/probes.cu ``sum_scalar_kernel`` as scalar float32 loops: block b
    reads its rounds of ``vec`` 16-byte vectors a thread (elements past n
    read as 0), each thread adds its elements in order from 0, each warp
    shuffles down (a lane past 31 reads its own value), warp 0 does the
    same over the warps' sums, and the last block does it all again over
    the blocks' partials, thread t taking partials t, t + threads, ..."""
    f32 = np.float32
    n, per_round = len(x), threads * vec * 4
    slices = max(1, -(-n // per_round))
    rounds = -(-slices // max_blocks)
    blocks = -(-slices // rounds)

    def shuffle_down(v, width):
        off = width // 2
        while off:
            v = [f32(v[lane] + v[lane + off if lane + off < 32 else lane]) for lane in range(32)]
            off //= 2
        return v[0]

    def tree(vals):
        warp_sums = [shuffle_down(vals[w * 32:(w + 1) * 32], 32) for w in range(threads // 32)]
        return shuffle_down(warp_sums + [f32(0.0)] * (32 - len(warp_sums)), threads // 32)

    partials = []
    for b in range(blocks):
        accs = []
        for t in range(threads):
            acc = f32(0.0)
            for r in range(rounds):
                for v in range(vec):
                    for c in range(4):
                        i = (b * rounds + r) * per_round + v * threads * 4 + t * 4 + c
                        acc = f32(acc + (x[i] if i < n else f32(0.0)))
            accs.append(acc)
        partials.append(tree(accs))
    last = []
    for t in range(threads):
        acc = f32(0.0)
        for j in range(t, blocks, threads):
            acc = f32(acc + partials[j])
        last.append(acc)
    return tree(last)


@pytest.mark.parametrize("n, max_blocks", [(3 * 4096 + 1234, cp.SUM_MAX_BLOCKS),
                                           (5 * 4096 + 77, 2)])
def test_sum_scalar_plain_follows_kernel_order(monkeypatch, n, max_blocks):
    """The plain version bit for bit against a scalar loop in the kernel's
    order: four blocks with a ragged tail; and, with the block cap cut to
    2 (at the kernel's cap that takes over 4M elements), three rounds a
    block on two blocks.  The values span six decades of both signs, so
    that another order rounds to other bits."""
    monkeypatch.setattr(cp, "SUM_MAX_BLOCKS", max_blocks)
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    want = _sum_in_kernel_order(x, cp.SUM_THREADS, cp.SUM_VEC, max_blocks)
    got = cp.sum_scalar(torch.from_numpy(x))
    assert got.numpy().view(np.int32)[0] == np.float32(want).view(np.int32)


def test_sum_scalar_refuses_misaligned_input():
    """The sum loads 16-byte vectors: a plane one float in is refused on
    either device."""
    flat = torch.arange(101, dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        cp.sum_scalar(flat[1:])
    assert torch.equal(cp.sum_scalar(flat[4:]), cp.sum_scalar_plain(flat[4:]))


@pytest.mark.parametrize("op", [op for op in cp.INTRINSICS if op != "cumsum_i32"])
def test_intrinsic_refuses_misaligned_operands(op):
    """The elementwise kernel's unary ops move 16-byte vectors, and every
    op keeps that rule: an operand one element into its storage is refused
    on either device (either operand of the two-operand ops), and one 16
    bytes in is taken."""
    t = port_mosaic.inputs("cpu", 105)
    args = port_mosaic.operands(op, t)
    with pytest.raises(ValueError, match="16-byte"):
        cp.intrinsic(op, *(a[1:] for a in args))
    if len(args) == 2:
        with pytest.raises(ValueError, match="16-byte"):
            cp.intrinsic(op, args[0][4:-1].clone(), args[1][1:-4])
    got = cp.intrinsic(op, *(a[4:] for a in args))
    assert torch.equal(got, cp.intrinsic_plain(op, *(a[4:] for a in args)))


def test_k1_work_and_bound():
    """``_common.arrival_work``, which every K1 bound of ``chip_smoke.py``
    uses: the distinct rows the live lanes read (each once), the ray
    planes once each, the state read and written; 576 operations per inner
    row, 55 per leaf triangle (at most 16), 30 per instance row on
    two-level tables only.  ``bound`` adds f32 and packed bf16 operations,
    the latter at twice the f32 rate."""
    from unity_webgpu_pathtracer_torch.experiments import _common

    rows, o, d, inv, st, active = _k1_inputs()
    rows.view(np.int32)[:8, 3] = -1                       # instance rows
    st = dict(st, ptr=np.where(np.arange(B) < 8, np.arange(B), st["ptr"]).astype(np.int32))
    s = _torch_state(st)
    planes = [torch.from_numpy(x) for x in (o, d, inv)]
    live = (st["ptr"] >= 0) & active
    meta = rows.view(np.int32)[st["ptr"][live], 3]
    tris = np.minimum(meta[meta > 0], 16).sum()
    state = sum(getattr(s, f).nbytes for f in ("ptr", "pend", "sp", "stack_row", "stack_mask",
                                               "t", "u", "v", "tri", "found"))
    distinct = len(np.unique(st["ptr"][live]))
    for inst in (False, True):
        nbytes, ops, n = _common.arrival_work(torch.from_numpy(rows), s.ptr, *planes, s,
                                              torch.from_numpy(active), inst)
        inst_state = 2 * (3 * 4 * B + 3 * 12 * B) if inst else 0
        assert n == distinct
        assert nbytes == distinct * 384 + 3 * 12 * B + B + 2 * state + inst_state
        assert ops == 576 * (meta == 0).sum() + 55 * tris + (30 * (meta < 0).sum() if inst else 0)
    f32_ms, by = _common.bound(0.0, 33.45408e9)
    assert (by, round(f32_ms, 9)) == ("operations", 1.0)
    assert round(_common.bound(0.0, 33.45408e9, 66.90816e9)[0], 9) == 2.0
    bytes_ms, by = _common.bound(3.35e10, 33.45408e9, 66.90816e9)
    assert (by, round(bytes_ms, 9)) == ("bytes", 10.0)


def test_bound_counts_issue_rates():
    """``bound`` prices unfused f32 operations at the H100's issue rate (132
    SMs x 128 lanes x 1.98 GHz: the kernels are built with -fmad=false, so
    no FMA counts twice) and packed bf16x2 lane-operations at twice it;
    bytes at 3.35 TB/s; the larger of the two binds."""
    from unity_webgpu_pathtracer_torch.experiments import _common

    assert _common.PEAK_F32 == 33.45408e12
    assert _common.PEAK_BF16 == 66.90816e12
    assert _common.PEAK_BYTES == 3.35e12
    assert _common.bound(0.0, 33.45408e12) == (1e3, "operations")
    assert _common.bound(0.0, 0.0, 66.90816e12) == (1e3, "operations")
    ms, by = _common.bound(0.0, 33.45408e12, 66.90816e12)
    assert (round(ms, 9), by) == (2e3, "operations")
    ms, by = _common.bound(3.35e12 * 1.5, 33.45408e12)
    assert (round(ms, 9), by) == (1.5e3, "bytes")
    # P6's bf16 chain: 13 f32 and 61 packed lane-operations a lane-repeat.
    from unity_webgpu_pathtracer_torch.experiments import round18_bf16_shade_probe as p6

    n = p6.B * cp.LOBE_REPEATS
    ms, _ = _common.bound(2 * 4 * p6.B, p6.BF16_F32_OPS * n, p6.BF16_PACKED_OPS * n)
    assert abs(ms - (13 / 33.45408e12 + 61 / 66.90816e12) * n * 1e3) < 1e-12


def _diet_tiny():
    """Three lanes on three rows: lane 0 live on an inner row (row 1) whose
    16 children are all empty, lane 1 live on a leaf of 2 degenerate
    triangles (row 2) with one stack entry, lane 2 dead (row 0 is a leaf);
    t = FAR_PLANE everywhere, so no triangle is taken."""
    nodes = torch.zeros((3, 96), dtype=torch.float32)
    ni = nodes.view(torch.int32)
    ni[0, 3], ni[1, 3], ni[2, 3] = 1, 0, 2
    ni[1, 32:48] = -1
    b, depth = 3, 2
    s = Wide16State(
        ptr=torch.tensor([1, 2, -1], dtype=torch.int32),
        pend=torch.full((b,), FULL, dtype=torch.int32),
        sp=torch.tensor([0, 1, 0], dtype=torch.int32),
        stack_row=torch.tensor([[5, 7, 5], [0, 0, 0]], dtype=torch.int32),
        stack_mask=torch.zeros((depth, b), dtype=torch.int32),
        t=torch.full((b,), 1e5), u=torch.zeros(b), v=torch.zeros(b),
        tri=torch.full((b,), -1, dtype=torch.int32), found=torch.zeros(b, dtype=torch.bool),
        inst=torch.full((b,), -1, dtype=torch.int32),
        hit_inst=torch.full((b,), -1, dtype=torch.int32),
        sp_enter=torch.zeros(b, dtype=torch.int32), local_o=torch.zeros((3, b)),
        local_d=torch.zeros((3, b)), local_inv=torch.zeros((3, b)))
    o = torch.tensor([[0.5, 0.5, 0.5]] * 3).T.contiguous()
    d = torch.tensor([[1.0, 2.0, 3.0]] * 3).T.contiguous()
    inv = (1.0 / d).contiguous()
    return nodes, torch.tensor([1, 2, 0], dtype=torch.int32), o, d, inv, s


# Bytes and f32 operations of each diet mode on ``_diet_tiny``, counted by
# hand: ptr and t of 3 lanes (24); rows, pend and sp of 2 live lanes (24);
# 16 a distinct row word group; 12 a ray plane triple; 8 lane 1's pop; 4
# each ptr, pend or sp that changes (lane 0's ptr, lane 1's ptr and sp).
# full: groups 0-11 of row 1 (12), 0 and the first 4 words of each comp
# of row 2 (10); o and inv of lane 0, o and d of lane 1; 576 + 2 x 55 ops.
# no_stack: the slab test on lane 1 too (groups 0-11, 13, 15, 17 of row 2;
# inv too), no pop, lane 1's ptr unchanged.  no_leaf: group 1 of every
# lane's row (row 0 for the dead lane), the leaf's kept loads.  no_inner:
# lane 0 reads inv only.
_DIET_TINY = {
    "full": (24 + 24 + 16 * 22 + 12 * 4 + 8 + 12, 576 + 110),
    "leaf_bf16": (24 + 24 + 16 * 22 + 12 * 4 + 8 + 12, 576 + 110),
    "leaf_noint": (24 + 24 + 16 * 22 + 12 * 4 + 8 + 12, 576 + 110),
    "no_stack": (24 + 24 + 16 * 27 + 12 * 5 + 0 + 8, 2 * 576 + 110),
    "no_leaf": (24 + 24 + 16 * 23 + 12 * 4 + 8 + 12, 576 + 3),
    "no_inner": (24 + 24 + 16 * 22 + 12 * 3 + 8 + 12, 110),
}


@pytest.mark.parametrize("mode", DIET_MODES)
def test_diet_work_counts_mode_bytes(mode):
    """``_common.diet_work``: each mode's own bytes and operations on a
    hand-built state of an inner, a leaf and a dead lane."""
    from unity_webgpu_pathtracer_torch.experiments import _common
    from unity_webgpu_pathtracer_torch.experiments.round14_kernel_diet import diet_step16

    nodes, rows, o, d, inv, s = _diet_tiny()
    out = diet_step16(nodes, rows, o.T, d.T, inv.T, s, None, mode)
    assert out.ptr[0] == -1 and int(out.sp[1]) == 0 and not bool(out.found.any())
    assert int(out.ptr[1]) == (2 if mode == "no_stack" else 7)
    nbytes, ops, counts = _common.diet_work(nodes, rows, o, d, inv, s, None, mode)
    assert (nbytes, ops) == _DIET_TINY[mode]
    assert counts["live"] == 2 and counts["improved"] == 0
    active = torch.tensor([True, True, False])
    assert _common.diet_work(nodes, rows, o, d, inv, s, active, mode)[0] == nbytes + 2


@pytest.mark.parametrize("mode", DIET_MODES)
def test_diet_in_place_wrapper_matches_diet_step16(mode):
    """The in-place wrapper (its plain path on the CPU) leaves in ``s``
    what ``diet_step16`` returns out of place, on every lane kind, with t >
    FAR_PLANE on some lanes (the leaf section's first slot then reaches
    every lane); it returns ``s`` and refuses a rows plane that shares the
    state's storage."""
    from unity_webgpu_pathtracer_torch.experiments.round14_kernel_diet import diet_step16

    rows, o, d, inv, st, active = _k1_inputs(seed=7)
    st["t"][::7] = 2e5
    s = _torch_state(st)
    args = [torch.from_numpy(x) for x in (rows, np.arange(B, dtype=np.int32), o, d, inv)]
    act = torch.from_numpy(active)
    want = diet_step16(args[0], args[1], args[2].T, args[3].T, args[4].T, s, act, mode)
    before = {f: getattr(s, f) for f in ("ptr", "t", "stack_row")}
    got = arrival_probe_cuda(*args, s, act, mode)
    assert got is s and all(getattr(s, f) is x for f, x in before.items())
    for f in ("ptr", "pend", "sp", "stack_row", "stack_mask", "t", "u", "v", "tri", "found"):
        a, b = getattr(s, f), getattr(want, f)
        assert torch.equal(a, b) or bool(((a == b) | (a.isnan() & b.isnan())).all()), f
    assert bool((want.t[::7] < 2e5).all())             # every far lane improved
    with pytest.raises(ValueError):
        arrival_probe_cuda(args[0], s.ptr, *args[2:], s, act, mode)


@pytest.mark.parametrize("mode", ["f16leaf", "bf16leaf"])
def test_leaf_decode_in_place_wrapper_matches_twin(mode):
    """The leaf decodes (P5) in place: the wrapper (its plain path on the
    CPU) leaves in ``s`` what the twin returns out of place with the row
    plane, on every lane kind; it returns ``s`` and refuses a rows plane
    that shares the state's storage."""
    from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_probe_plain

    rows, o, d, inv, st, active = _k1_inputs(seed=9)
    s = _torch_state(st)
    args = [torch.from_numpy(x) for x in (rows, np.roll(st["ptr"], 5).copy(), o, d, inv)]
    act = torch.from_numpy(active)
    want = arrival_probe_plain(*args, s, act, mode)
    before = {f: getattr(s, f) for f in ("ptr", "t", "stack_row")}
    got = arrival_probe_cuda(*args, s, act, mode)
    assert got is s and all(getattr(s, f) is x for f, x in before.items())
    for f in ("ptr", "pend", "sp", "stack_row", "stack_mask", "t", "u", "v", "tri", "found"):
        a, b = getattr(s, f), getattr(want, f)
        assert torch.equal(a, b) or bool(((a == b) | (a.isnan() & b.isnan())).all()), f
    assert bool((s.found & ~torch.from_numpy(st["found"])).any())   # some lane hit
    assert bool((s.sp > torch.from_numpy(st["sp"])).any())          # some lane pushed
    with pytest.raises(ValueError):
        arrival_probe_cuda(args[0], s.ptr, *args[2:], s, act, mode)


# ``arrivals_work`` on ``_diet_tiny`` (one arrival, counted by hand): ptr of
# 3 lanes (12); per lane that steps 2 x 29 bytes of scalar state less ptr
# and 36 of rays (90), 4 more with a row plane; 384 a distinct row; 8 for
# lane 1's pop from memory (sp 1); 576 ops an inner row, 55 a leaf slot.
# ptr: lane 0 on inner row 1, lane 1 on leaf row 2.  rows = [2, 2, 0]: both
# on leaf row 2.  With active [1, 0, 1]: lane 0 alone, plus the mask (3).
_ARRIVALS_TINY = {
    "ptr": (12 + 2 * 90 + 2 * 384 + 8, 576 + 2 * 55),
    "rows": (12 + 2 * 94 + 384 + 8, 2 * 2 * 55),
    "rows, active": (12 + 3 + 94 + 384, 2 * 55),
}


@pytest.mark.parametrize("case", _ARRIVALS_TINY)
def test_arrivals_work_counts_row_plane(case):
    """``_common.arrivals_work`` with a probe's row plane (P5's in-place
    bound) and without (the render path's): its bytes and operations on a
    hand-built state, the rows a lane loads taken from the plane."""
    from unity_webgpu_pathtracer_torch.experiments import _common

    nodes, _rows, o, d, inv, s = _diet_tiny()
    rows = None if case == "ptr" else torch.tensor([2, 2, 0], dtype=torch.int32)
    active = torch.tensor([True, False, True]) if "active" in case else None
    nbytes, ops, distinct, counts = _common.arrivals_work(nodes, o, d, inv, s, 1, active,
                                                          rows=rows)
    assert (nbytes, ops) == _ARRIVALS_TINY[case]
    assert distinct == (2 if rows is None else 1)
    assert counts == dict(lanes=1 if active is not None else 2, pushes=0,
                          pops=0 if active is not None else 1)


def test_schlick_short_remainder_bound():
    """csrc/probes.cu's P3: where |acc| < 1000 after the chain's first block
    (``REM_SAFE_ACC``), every later dividend |acc * 0.3 + 0.1| stays below
    320, far under the short remainder's limit, so the 39 later blocks may
    take it with no test.  Checked in the plain chain on the probe's input,
    on inputs of either sign over 25 binades and on [-1, 2] with its edges,
    where acc grows most."""
    rng = np.random.default_rng(13)
    x = np.concatenate([np.linspace(0.1, 0.9, 262144),
                        2.0 ** rng.uniform(-20, 5, 8192) * rng.choice([-1.0, 1.0], 8192),
                        np.linspace(-1.0, 2.0, 65537), [0.0, 1.0, 0.05, 0.95]])
    v = torch.from_numpy(x.astype(np.float32))
    acc = torch.zeros_like(v)
    later = None
    for k in range(cp.SCHLICK_BLOCKS):
        w = 1.0 - v
        w2 = w * w
        f = w2 * w2 * w
        acc = acc + f * umath.sqrt(torch.abs(v * 0.9 + 0.05)) + v * (1.0 - f)
        a = torch.abs(acc * 0.3 + 0.1)
        if k == 0:
            safe = acc.abs() < 1000.0
        else:
            later = a[safe] if later is None else torch.maximum(later, a[safe])
        v = torch.fmod(a, 0.9) + 0.05
    assert int(safe.sum()) > 300_000 and float(later.max()) < 320.0
