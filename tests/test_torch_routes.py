"""PyTorch port: the forward routes of the NF4 (B1), int8 (B8) and int4
(B6) matmuls.

Each wrapper picks its forward kernel by shape (``_route``): for NF4 and
int8 the split-K ``mma.sync`` kernel below ``WGMMA_MIN_M`` rows and for the
shapes the ``wgmma`` mainloop cannot take, the mainloop from the threshold
up; for int4 the thin-M kernel in place of split-K (its table is in
``test_torch_int4.py``). On the card the route decides which kernel
launches; here, on the CPU, every route is the plain version, so the tables
pin the choice itself, for every row count and ragged shape
``chip_smoke.py`` runs on the card. An explicit route the shape does not
take raises (no fallback), and the wrapper hands the kernels 16-byte-aligned
arrays even where the weight is an offset view.
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
from llm_in_practise_tpu_torch.quant import int4 as port_int4
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
    # split-K (int4: the thin-M kernel) takes every shape; no route means
    # _route's pick
    always = "thin" if mod is i4 else "splitk"
    assert mod._checked_route(*args, always) == always
    assert mod._checked_route(*args, None) == mod._route(*args)


def test_launch_counters_by_route():
    for fn in (nm.nf4_matmul, i8.int8_matmul):
        assert tuple(fn.launches_by_route) == nm.ROUTES == ("wgmma",
                                                            "splitk")
    assert tuple(i4.int4_matmul.launches_by_route) == i4.ROUTES == (
        "wgmma", "thin")
    assert {"nf4_matmul_wgmma_launch", "nf4_matmul_launch"} <= set(
        _build.KERNELS["nf4_matmul"])
    assert {"int8_matmul_wgmma_launch", "int8_matmul_launch"} <= set(
        _build.KERNELS["int8_matmul"])
    # the int4 split-K kernel is gone: the thin-M kernel took its rows
    assert {"int4_matmul_wgmma_launch", "int4_matmul_thin_launch"} <= set(
        _build.KERNELS["int4_matmul"])
    assert "int4_matmul_launch" not in _build.KERNELS["int4_matmul"]


@pytest.mark.parametrize("args,match", [
    ((8, 99, 4096, 32), r"even K and an even group size; got K=99 with "
                        r"group_size 32"),
    ((8, 96, 4096, 3), r"even K and an even group size; got K=96 with "
                       r"group_size 3")], ids=["odd_k", "odd_gs"])
def test_explicit_thin_route_on_a_shape_it_cannot_take_raises(args, match):
    with pytest.raises(ValueError, match=match):
        i4._checked_route(*args, "thin")
    # every even K and even group size, at any M and N, takes it
    for shape in ((1, 10, 40, 2), (8191, 4096, 1040, 96), (8, 96, 4096, 32)):
        assert i4._checked_route(*shape, "thin") == "thin"


@pytest.mark.parametrize("fmt", ["nf4", "int8", "int4"])
def test_both_routes_on_the_cpu_are_the_plain_version(fmt):
    rng = np.random.default_rng(11)
    w = rng.normal(0, 0.02, (128, 96)).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 1, (5, 128)).astype(np.float32))
    if fmt == "nf4":
        mod, t, plain = nm, port_nf4.quantize(w), nm.nf4_matmul_reference
        counter = nm.nf4_matmul
    elif fmt == "int8":
        mod, t, plain = i8, port_int8.quantize(w), i8.int8_matmul_reference
        counter = i8.int8_matmul
    else:
        mod, t = i4, port_int4.rtn_quantize(w, group_size=32)
        plain, counter = i4.int4_matmul_reference, i4.int4_matmul
    before = (counter.launches, dict(counter.launches_by_route))
    want = plain(x, t, torch.bfloat16)
    for route in (None, *mod.ROUTES):
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


def test_chip_smoke_route_launches_per_route():
    """chip_smoke's expected launches per route: each pass's projections on
    the route ``_route`` picks for its rows, times the layers."""
    cs = _chip_smoke()
    shapes = list(cs.PROJ_SHAPES.values())
    assert cs.route_launches("int4", [364, 8, 8, 5], shapes, 36) == {
        "wgmma": 7 * 36, "thin": 3 * 7 * 36}
    assert cs.route_launches("nf4", [364, 8], shapes, 2) == {
        "wgmma": 14, "splitk": 14}
    # the training step's forwards: 7 projections and the remat recompute
    # of all but down_proj
    assert cs.route_launches("nf4", [cs.TRAIN_M], shapes + shapes[:-1],
                             36) == {"wgmma": 468, "splitk": 0}


def test_chip_smoke_reads_the_thin_and_flash_kernels_ptxas():
    """qmm_resources also reports B6's thin-M kernel (per instantiation)
    and the wgmma flash forward (per head_dim)."""
    cs = _chip_smoke()
    log = (
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1_14int4_"
        "matmul_cu_116int4_thin_kernelILi1ELb1EEEvPK13__nv_bfloat16' for "
        "'sm_90a'\n"
        "ptxas info    : Used 72 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__1_18flash"
        "_attention_cu_116flash_fwd_kernelILi128EEEv14CUtensorMap_st' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN51_flash_fwd_kernelILi128"
        "\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 16 barriers, 64 bytes smem\n")
    saved = dict(_build.ptxas_log)
    try:
        _build.ptxas_log.clear()
        _build.ptxas_log["int4_matmul"] = log
        _build.ptxas_log["flash_attention"] = log
        got = cs.qmm_resources()
    finally:
        _build.ptxas_log.clear()
        _build.ptxas_log.update(saved)
    assert "72 registers" in got["int4_thin_kernelILi1ELb1E"]["ptxas"]
    flash = got["flash_fwd_kernelILi128E"]
    assert "168 registers" in flash["ptxas"] and "0 bytes spill" in \
        flash["ptxas"] and not flash["c7515"]
    assert set(cs.PTXAS_LABELS["flash_forward"]) == set(cs.FLASH_FWD_LABELS)


def _thin_rows_per_block(m: int) -> int:
    """Rows of x per block of the thin-M kernel instantiation that
    ``int4_matmul_thin_launch`` picks for ``m`` rows (8 MT)."""
    for rows in (8, 16, 32, 64):
        if m <= rows:
            return rows
    return 128


def test_chip_smoke_repeats_every_thin_instantiation():
    """chip_smoke's determinism sweep of the thin route launches every
    instantiation of the kernel (8 to 128 rows of x per block), with a
    ragged row count where the instantiation has one, and the dispatch in
    the C source still has those five."""
    cs = _chip_smoke()
    ms = cs.THIN_REPEAT_M
    assert {_thin_rows_per_block(m) for m in ms} == {8, 16, 32, 64, 128}
    assert cs.THIN_REPEATS >= 2
    assert any(m % 8 for m in ms if m > 16)
    src = _build.source_path("int4_matmul").read_text()
    for mt in (1, 2, 4, 8, 16):
        assert f"launch_thin_mt<{mt}>" in src
