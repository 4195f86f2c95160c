"""PyTorch port: the forward routes of the NF4 (B1) and int8 (B8) matmuls.

Each wrapper picks its forward kernel by shape (``_route``): the split-K
``mma.sync`` kernel below ``WGMMA_MIN_M`` rows and for the shapes the
``wgmma`` mainloop cannot take, the mainloop from the threshold up. On the
card the route decides which kernel launches; here, on the CPU, both routes
are the plain version, so the tables below pin the choice itself, for every
row count and ragged shape ``chip_smoke.py`` runs on the card. An explicit
route the shape does not take raises (no fallback), and the wrapper hands
the kernels 16-byte-aligned arrays even where the weight is an offset view.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from llm_in_practise_tpu_torch.ops import _build
from llm_in_practise_tpu_torch.ops import int4_matmul as i4
from llm_in_practise_tpu_torch.ops import int8_matmul as i8
from llm_in_practise_tpu_torch.ops import nf4_matmul as nm
from llm_in_practise_tpu_torch.quant import int8 as port_int8
from llm_in_practise_tpu_torch.quant import nf4 as port_nf4


def _chip_smoke():
    """chip_smoke.py's module (its top level imports only the standard
    library), for the shapes it runs on the card."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (M, K, N) -> the NF4 forward kernel chip_smoke's shapes take
_NF4_ROUTES = {
    # decode and the crossover table's split-K side
    (1, 4096, 4096): "splitk", (8, 4096, 12288): "splitk",
    (8, 12288, 4096): "splitk", (16, 4096, 1024): "splitk",
    (64, 4096, 4096): "splitk", (128, 12288, 4096): "splitk",
    (17, 4096, 4096): "splitk", (255, 4096, 4096): "splitk",
    # from WGMMA_MIN_M up: prefill, the step checks (2 x 1024 rows),
    # training (8 x 1024)
    (256, 4096, 4096): "wgmma", (364, 4096, 1024): "wgmma",
    (512, 4096, 12288): "wgmma", (2048, 12288, 4096): "wgmma",
    (8192, 4096, 1024): "wgmma", (8191, 4096, 4096): "wgmma",
    # ragged shapes: M off the tile, one stage, N/2 % 64 == 32, a low-half
    # absmax run across a scale block; N % 32 != 0 stays on split-K
    (333, 4096, 4096): "wgmma", (333, 64, 4096): "wgmma",
    (333, 4096, 192): "wgmma", (333, 4096, 1088): "wgmma",
    (333, 4096, 200): "splitk",
    # shapes the wgmma forward does not take, at any M
    (8192, 4096, 48): "splitk", (8192, 4096, 4098): "splitk",
    (8192, 4096, 32): "wgmma",
}

# (M, K, N) -> the int8 forward kernel chip_smoke's shapes take
_INT8_ROUTES = {
    (1, 4096, 4096): "splitk", (8, 4096, 12288): "splitk",
    (8, 12288, 4096): "splitk", (64, 4096, 1024): "splitk",
    (128, 4096, 4096): "splitk", (255, 12288, 4096): "splitk",
    (256, 4096, 4096): "wgmma", (364, 4096, 12288): "wgmma",
    (1024, 4096, 1024): "wgmma", (2048, 12288, 4096): "wgmma",
    (8192, 4096, 4096): "wgmma", (8191, 4096, 4096): "wgmma",
    # ragged shapes: K off the 64-row stage, N off the 128-column tile;
    # K = 10 (2K bytes no 16-byte multiple) stays on split-K
    (333, 4096, 4096): "wgmma", (333, 96, 4096): "wgmma",
    (333, 4096, 48): "wgmma", (333, 4096, 1040): "wgmma",
    (333, 10, 4096): "splitk",
    # shapes the wgmma forward does not take, at any M
    (8192, 4096, 40): "splitk", (8192, 4100, 4096): "splitk",
    (8192, 8, 16): "wgmma",
}


@pytest.mark.parametrize("m,k,n", sorted(_NF4_ROUTES))
def test_nf4_route_table(m, k, n):
    assert nm._route(m, k, n) == _NF4_ROUTES[(m, k, n)]


@pytest.mark.parametrize("m,k,n", sorted(_INT8_ROUTES))
def test_int8_route_table(m, k, n):
    assert i8._route(m, k, n) == _INT8_ROUTES[(m, k, n)]


@pytest.mark.parametrize("mod,table,edges", [
    (nm, _NF4_ROUTES, "NF4_FWD_EDGE_SHAPES"),
    (i8, _INT8_ROUTES, "INT8_FWD_EDGE_SHAPES")], ids=["nf4", "int8"])
def test_route_table_covers_the_chip_smoke_shapes(mod, table, edges):
    cs = _chip_smoke()
    assert mod.WGMMA_MIN_M == 256
    for m in cs.CHECK_M + cs.CROSSOVER_M + cs.PTQ_CHECK_M:
        for k, n in set(cs.PROJ_SHAPES.values()):
            want = "wgmma" if m >= mod.WGMMA_MIN_M else "splitk"
            assert mod._route(m, k, n) == want, (m, k, n)
    # every ragged forward shape is in the table above
    assert set(getattr(cs, edges)) <= set(table)
    # the step checks' and the training step's forwards all take wgmma
    for m in (cs.STEP_BATCH * cs.TRAIN_SEQ, cs.TRAIN_M):
        assert all(mod._route(m, k, n) == "wgmma"
                   for k, n in cs.PROJ_SHAPES.values())


@pytest.mark.parametrize("mod,args,match", [
    (nm, (512, 4096, 200), r"K % 64 == 0 and N % 32 == 0; got K=4096, "
                           r"N=200"),
    (i8, (512, 10, 4096), r"K % 8 == 0 and N % 16 == 0; got K=10, N=4096"),
    (i4, (512, 4096, 4096, 96), r"gs % 64 == 0 or 64 % gs == 0; got "
                                r"K=4096, N=4096 with group_size 96")],
    ids=["nf4", "int8", "int4"])
def test_explicit_wgmma_route_on_a_shape_it_cannot_take_raises(mod, args,
                                                               match):
    with pytest.raises(ValueError, match=match):
        mod._checked_route(*args, "wgmma")
    with pytest.raises(ValueError, match="route must be one of"):
        mod._checked_route(*args, "cublas")
    # split-K takes every shape; no route means _route's pick
    assert mod._checked_route(*args, "splitk") == "splitk"
    assert mod._checked_route(*args, None) == mod._route(*args)


def test_launch_counters_by_route():
    for fn in (nm.nf4_matmul, i8.int8_matmul, i4.int4_matmul):
        assert tuple(fn.launches_by_route) == nm.ROUTES == ("wgmma",
                                                            "splitk")
    assert {"nf4_matmul_wgmma_launch", "nf4_matmul_launch"} <= set(
        _build.KERNELS["nf4_matmul"])
    assert {"int8_matmul_wgmma_launch", "int8_matmul_launch"} <= set(
        _build.KERNELS["int8_matmul"])


@pytest.mark.parametrize("fmt", ["nf4", "int8"])
def test_both_routes_on_the_cpu_are_the_plain_version(fmt):
    rng = np.random.default_rng(11)
    w = rng.normal(0, 0.02, (128, 96)).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 1, (5, 128)).astype(np.float32))
    if fmt == "nf4":
        mod, t, plain = nm, port_nf4.quantize(w), nm.nf4_matmul_reference
        counter = nm.nf4_matmul
    else:
        mod, t, plain = i8, port_int8.quantize(w), i8.int8_matmul_reference
        counter = i8.int8_matmul
    before = (counter.launches, dict(counter.launches_by_route))
    want = plain(x, t, torch.bfloat16)
    for route in (None, "wgmma", "splitk"):
        got = mod._forward(x, t, torch.bfloat16, route=route)
        assert torch.equal(got, want)
    # the CPU path launches nothing, on either route
    assert (counter.launches, dict(counter.launches_by_route)) == before


def test_aligned_copies_an_offset_view():
    buf = torch.arange(65, dtype=torch.uint8)
    view = buf[1:].view(4, 16)
    assert view.data_ptr() % 16 != 0
    got = nm._aligned(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, view)
    aligned = buf[:64].view(4, 16)
    assert nm._aligned(aligned).data_ptr() == aligned.data_ptr()


def test_chip_smoke_offset_views_keep_the_weight():
    """chip_smoke's alignment case: the same NF4 weight with every array an
    offset view decodes, and multiplies, to the same values."""
    cs = _chip_smoke()
    rng = np.random.default_rng(12)
    t = port_nf4.quantize(rng.normal(0, 0.02, (128, 256)).astype(np.float32))
    shifted = cs.nf4_offset_views(t)
    for name in ("packed", "absmax_q", "absmax_scale"):
        assert getattr(shifted, name).data_ptr() % 16 != 0
        assert torch.equal(getattr(shifted, name), getattr(t, name))
    x = torch.from_numpy(rng.normal(0, 1, (3, 128)).astype(np.float32))
    assert torch.equal(nm.nf4_matmul(x, shifted), nm.nf4_matmul(x, t))


def test_chip_smoke_reads_c7515_per_policy():
    """qmm_resources attributes ptxas's C7515 warning (wgmma serialized) to
    the policy named in it, and registers to the entry that follows."""
    cs = _chip_smoke()
    log = (
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async"
        " instructions are serialized in the function '_ZN3qmm16qmm_wgmma_"
        "kernelIN12_GLOBAL__N_16Nf4FwdEEEv'\n"
        "ptxas info    : Compiling entry function '_ZN3qmm16qmm_wgmma_"
        "kernelIN12_GLOBAL__N_16Nf4FwdEEEv' for 'sm_90a'\n"
        "ptxas info    : Used 168 registers, used 2 barriers, 128 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN3qmm16qmm_wgmma_"
        "kernelIN12_GLOBAL__N_17Int8FwdEEEv' for 'sm_90a'\n"
        "ptxas info    : Used 168 registers, used 2 barriers, 64 bytes smem\n")
    saved = dict(_build.ptxas_log)
    try:
        _build.ptxas_log.clear()
        _build.ptxas_log["nf4_matmul"] = log
        got = cs.qmm_resources()
    finally:
        _build.ptxas_log.clear()
        _build.ptxas_log.update(saved)
    assert got["Nf4Fwd"]["c7515"] and not got["Int8Fwd"]["c7515"]
    assert "168 registers" in got["Nf4Fwd"]["ptxas"]
    assert "64 bytes smem" in got["Int8Fwd"]["ptxas"]
