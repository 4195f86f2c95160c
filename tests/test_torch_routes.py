"""PyTorch port: the forward routes of the NF4 (B1), int8 (B8) and int4
(B6) matmuls.

Each wrapper picks its forward kernel by shape (``_route``): the thin-M
streaming kernel of ``csrc/qmm_thin.cuh`` below ``WGMMA_MIN_M`` rows and
for the shapes the ``wgmma`` mainloop cannot take, the mainloop from the
threshold up (int4's table is in ``test_torch_int4.py``); the split-K
kernels are gone in all three formats. On the card the route decides which kernel
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
    # decode and the crossover table's thin side
    (1, 4096, 4096): "thin", (8, 4096, 12288): "thin",
    (8, 12288, 4096): "thin", (16, 4096, 1024): "thin",
    (64, 4096, 4096): "thin", (128, 12288, 4096): "thin",
    (17, 4096, 4096): "thin", (255, 4096, 4096): "thin",
    # from WGMMA_MIN_M up: prefill, the step checks (2 x 1024 rows),
    # training (8 x 1024)
    (256, 4096, 4096): "wgmma", (364, 4096, 1024): "wgmma",
    (512, 4096, 12288): "wgmma", (2048, 12288, 4096): "wgmma",
    (8192, 4096, 1024): "wgmma", (8191, 4096, 4096): "wgmma",
    # ragged shapes: M off the tile, one stage, N/2 % 64 == 32, a low-half
    # absmax run across a scale block; N % 32 != 0 stays on thin
    (333, 4096, 4096): "wgmma", (333, 64, 4096): "wgmma",
    (333, 4096, 192): "wgmma", (333, 4096, 1088): "wgmma",
    (333, 4096, 200): "thin",
    # shapes the wgmma forward does not take, at any M
    (8192, 4096, 48): "thin", (8192, 4096, 4098): "thin",
    (8192, 4096, 32): "wgmma",
}

# (M, K, N) -> the int8 forward kernel chip_smoke's shapes take
_INT8_ROUTES = {
    (1, 4096, 4096): "thin", (8, 4096, 12288): "thin",
    (8, 12288, 4096): "thin", (64, 4096, 1024): "thin",
    (128, 4096, 4096): "thin", (255, 12288, 4096): "thin",
    (256, 4096, 4096): "wgmma", (364, 4096, 12288): "wgmma",
    (1024, 4096, 1024): "wgmma", (2048, 12288, 4096): "wgmma",
    (8192, 4096, 4096): "wgmma", (8191, 4096, 4096): "wgmma",
    # ragged shapes: K off the 64-row stage, N off the 128-column tile;
    # K = 10 (2K bytes no 16-byte multiple) stays on thin
    (333, 4096, 4096): "wgmma", (333, 96, 4096): "wgmma",
    (333, 4096, 48): "wgmma", (333, 4096, 1040): "wgmma",
    (333, 10, 4096): "thin",
    # shapes the wgmma forward does not take, at any M
    (8192, 4096, 40): "thin", (8192, 4100, 4096): "thin",
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
    for m in (cs.CHECK_M + cs.THIN_CROSSOVER_M + cs.PTQ_CHECK_M
              + cs.THIN_CHECK_M + cs.DECODE_M):
        for k, n in set(cs.PROJ_SHAPES.values()):
            want = "wgmma" if m >= mod.WGMMA_MIN_M else "thin"
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
    # the thin-M kernel takes every shape these wrappers admit; no route
    # means _route's pick
    assert mod._checked_route(*args, "thin") == "thin"
    assert mod._checked_route(*args, None) == mod._route(*args)


def test_launch_counters_by_route():
    for mod, fn in ((nm, nm.nf4_matmul), (i8, i8.int8_matmul),
                    (i4, i4.int4_matmul)):
        assert tuple(fn.launches_by_route) == mod.ROUTES == ("wgmma", "thin")
    # every forward's decode route is the thin-M template; the split-K
    # kernels and their reduce launches are gone in all three formats
    for name in ("nf4_matmul", "int4_matmul", "int8_matmul"):
        syms = set(_build.KERNELS[name])
        assert {f"{name}_wgmma_launch", f"{name}_thin_launch"} <= syms
        assert f"{name}_launch" not in syms
        src = _build.source_path(name).read_text()
        assert '#include "qmm_thin.cuh"' in src
        assert "splitk_reduce" not in src and "split_k" not in src


# (format, (M, K, N[, group size]), message): shapes the thin forward does
# not take; every shape the format's _check_weight admits takes it
_THIN_REFUSED = [
    ("int4", (8, 99, 4096, 32), r"even K and an even group size; got K=99 "
                                r"with group_size 32"),
    ("int4", (8, 96, 4096, 3), r"even K and an even group size; got K=96 "
                               r"with group_size 3"),
    ("nf4", (8, 96, 4096), r"K % 64 == 0 and an even N; got K=96, N=4096"),
    ("nf4", (8, 4096, 201), r"K % 64 == 0 and an even N; got K=4096, "
                            r"N=201"),
    ("int8", (8, 0, 4096), r"K >= 1 and N >= 1; got K=0, N=4096"),
    ("int8", (8, 4096, 0), r"K >= 1 and N >= 1; got K=4096, N=0")]
# shapes each format admits, at any M: all take the thin route
_THIN_TAKES = {
    "int4": ((1, 10, 40, 2), (8191, 4096, 1040, 96), (8, 96, 4096, 32)),
    "nf4": ((1, 64, 2), (8, 4096, 200), (255, 192, 4096), (8191, 4096, 202),
            (8, 12288, 4096)),
    "int8": ((1, 1, 1), (8, 10, 4096), (8, 99, 40), (255, 4100, 4098),
             (8191, 4096, 1040))}


@pytest.mark.parametrize("fmt,args,match", _THIN_REFUSED,
                         ids=["int4-odd_k", "int4-odd_gs", "nf4-k_off_64",
                              "nf4-odd_n", "int8-no_k", "int8-no_n"])
def test_explicit_thin_route_on_a_shape_it_cannot_take_raises(fmt, args,
                                                              match):
    mod = {"nf4": nm, "int8": i8, "int4": i4}[fmt]
    with pytest.raises(ValueError, match=match):
        mod._checked_route(*args, "thin")
    # every shape the format admits, at any M and N, takes it
    for shape in _THIN_TAKES[fmt]:
        assert mod._checked_route(*shape, "thin") == "thin"
        if mod is not i4:
            assert mod._route(*shape) == ("wgmma" if mod._wgmma_shape(
                *shape[1:]) and shape[0] >= mod.WGMMA_MIN_M else "thin")


@pytest.mark.parametrize("fmt", ["nf4", "int8"])
def test_every_admitted_shape_takes_the_thin_route(fmt):
    """NF4 admits every kblock shape (K % 64 == 0, even N) and int8 every
    2-D shape: below WGMMA_MIN_M all of them, and from it those the wgmma
    forward cannot take, run on thin (there is no other route)."""
    mod = {"nf4": nm, "int8": i8}[fmt]
    ks = (64, 192, 4096, 12288) if fmt == "nf4" else (1, 10, 99, 4096)
    ns = (2, 200, 202, 4096) if fmt == "nf4" else (1, 40, 1000, 4096)
    for m in (1, 8, 17, 255, 256, 8192):
        for k in ks:
            for n in ns:
                route = mod._route(m, k, n)
                assert mod._checked_route(m, k, n, route) == route
                if m < mod.WGMMA_MIN_M or not mod._wgmma_shape(k, n):
                    assert route == "thin", (m, k, n)


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
        "wgmma": 14, "thin": 14}
    assert cs.route_launches("int8", [255, 256], shapes, 3) == {
        "wgmma": 21, "thin": 21}
    # the training step's forwards: 7 projections and the remat recompute
    # of all but down_proj
    assert cs.route_launches("nf4", [cs.TRAIN_M], shapes + shapes[:-1],
                             36) == {"wgmma": 468, "thin": 0}


def test_chip_smoke_reads_the_thin_and_flash_kernels_ptxas():
    """qmm_resources also reports the thin-M kernel of every forward format
    (per policy and instantiation) and the wgmma flash forward (per
    head_dim)."""
    cs = _chip_smoke()

    def entry(src, policy, mt, fast, regs):
        return (
            "ptxas info    : Compiling entry function '_ZN4thin15qmm_thin_"
            f"kernelIN47_GLOBAL__N__9d4bcc61_14_{src}_cu_4a6699fe8{policy}"
            f"ELi{mt}ELb{fast}EEEv14CUtensorMap_stS2_S2_S2_NS_8ThinArgsE' "
            "for 'sm_90a'\n"
            f"ptxas info    : Used {regs} registers, used 2 barriers, 96 "
            "bytes smem\n")

    log = (
        entry("nf4_matmul", "Nf4Thin", 1, 1, 71)
        + entry("nf4_matmul", "Nf4Thin", 16, 0, 168)
        + entry("int4_matmul", "Int4Thin", 1, 1, 72)
        + entry("int8_matmul", "Int8Thin", 2, 0, 60)
        + "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__1_18"
        "flash_attention_cu_116flash_fwd_kernelILi128EEEv14CUtensorMap_st' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN51_flash_fwd_kernelILi128"
        "\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 16 barriers, 64 bytes smem"
        "\n")
    saved = dict(_build.ptxas_log)
    try:
        _build.ptxas_log.clear()
        for src in ("nf4_matmul", "int4_matmul", "int8_matmul",
                    "flash_attention"):
            _build.ptxas_log[src] = log
        got = cs.qmm_resources()
    finally:
        _build.ptxas_log.clear()
        _build.ptxas_log.update(saved)
    assert "71 registers" in got["Nf4ThinELi1ELb1E"]["ptxas"]
    assert "168 registers" in got["Nf4ThinELi16ELb0E"]["ptxas"]
    assert "72 registers" in got["Int4ThinELi1ELb1E"]["ptxas"]
    assert "60 registers" in got["Int8ThinELi2ELb0E"]["ptxas"]
    assert "Nf4ThinELi1ELb0E" not in got  # not in this log
    flash = got["flash_fwd_kernelILi128E"]
    assert "168 registers" in flash["ptxas"] and "0 bytes spill" in \
        flash["ptxas"] and not flash["c7515"]
    assert set(cs.PTXAS_LABELS["flash_forward"]) == set(cs.FLASH_FWD_LABELS)
    # every instantiation of each format's thin kernel is read, under the
    # format's forward kernel
    for fmt, policy in cs.THIN_POLICIES.items():
        labels = cs.thin_labels(fmt)
        assert len(set(labels)) == 10
        assert all(lab.startswith(policy) for lab in labels)
        assert set(labels) <= set(cs.PTXAS_LABELS[f"{fmt}_matmul"])


def test_chip_smoke_reads_the_flash_backward_ptxas():
    """qmm_resources reports the wgmma dK/dV and dQ kernels per head_dim
    (registers, spills and C7515) apart from the forward, and the kernel
    table files each under its own kernel."""
    cs = _chip_smoke()

    def entry(kernel, d, regs, spill):
        name = (f"_ZN51_GLOBAL__N__1_18flash_attention_cu_1{kernel}ILi{d}"
                "EEEv14CUtensorMap_stS0_S0_S0_PKfS2_P13__nv_bfloat16ii")
        return (
            f"ptxas info    : Compiling entry function '{name}' for "
            "'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
            "bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 16 barriers, 1600 "
            "bytes smem\n")

    log = (
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async"
        " instructions are serialized in the function '_ZN51_GLOBAL__N__1_18"
        "flash_attention_cu_119flash_bwd_dq_kernelILi64EEEv14CUtensorMap_st'"
        "\n"
        + entry("flash_bwd_dkv_kernel", 128, 240, 0)
        + entry("flash_bwd_dkv_kernel", 64, 200, 0)
        + entry("flash_bwd_dq_kernel", 128, 238, 24)
        + entry("flash_bwd_dq_kernel", 64, 180, 0)
        + entry("flash_fwd_kernel", 128, 168, 0))
    saved = dict(_build.ptxas_log)
    try:
        _build.ptxas_log.clear()
        _build.ptxas_log["flash_attention"] = log
        got = cs.qmm_resources()
    finally:
        _build.ptxas_log.clear()
        _build.ptxas_log.update(saved)
    dkv = got["flash_bwd_dkv_kernelILi128E"]
    assert "240 registers" in dkv["ptxas"] and "0 bytes spill" in \
        dkv["ptxas"] and not dkv["c7515"]
    assert "200 registers" in got["flash_bwd_dkv_kernelILi64E"]["ptxas"]
    dq = got["flash_bwd_dq_kernelILi128E"]
    assert "238 registers" in dq["ptxas"] and "24 bytes spill stores" in \
        dq["ptxas"] and not dq["c7515"]
    assert got["flash_bwd_dq_kernelILi64E"]["c7515"]
    assert "168 registers" in got["flash_fwd_kernelILi128E"]["ptxas"]
    assert set(cs.PTXAS_LABELS["flash_backward_dkv"]) == {
        "flash_bwd_dkv_kernelILi128E", "flash_bwd_dkv_kernelILi64E"}
    assert set(cs.PTXAS_LABELS["flash_backward_dq"]) == {
        "flash_bwd_dq_kernelILi128E", "flash_bwd_dq_kernelILi64E"}
    # no label of one flash kernel names an instantiation of another
    flash = [lab for k, labs in cs.PTXAS_LABELS.items()
             if k.startswith("flash") for lab in labs]
    assert len(flash) == len(set(flash)) == 6
    for lab in flash:
        assert sum(lab in other for other in flash) == 1


def _thin_rows_per_block(m: int) -> int:
    """Rows of x per block of the thin-M kernel instantiation that
    ``thin::launch_rows`` picks for ``m`` rows (8 MT)."""
    for rows in (8, 16, 32, 64):
        if m <= rows:
            return rows
    return 128


def test_chip_smoke_repeats_every_thin_instantiation():
    """chip_smoke's determinism sweep of the thin route launches every
    instantiation of the kernel (8 to 128 rows of x per block, the TMA and
    the plain-load path) in all three formats, with a ragged row count
    where the instantiation has one, and the dispatch in the template still
    has those five."""
    cs = _chip_smoke()
    ms = cs.THIN_REPEAT_M
    assert {_thin_rows_per_block(m) for m in ms} == {8, 16, 32, 64, 128}
    assert cs.THIN_REPEATS >= 2
    assert any(m % 8 for m in ms if m > 16)
    assert cs.MAX_SLOTS in ms  # the planted-fault launch
    assert set(cs.THIN_REPEAT_SHAPES) == set(cs.FWD_FORMATS)
    for fmt, shapes in cs.THIN_REPEAT_SHAPES.items():
        assert [cs.thin_path(fmt, *shape) for shape in shapes] == [
            "tma", "plain"], fmt
        mod = {"nf4": nm, "int8": i8, "int4": i4}[fmt]
        for k, n, gs in shapes:  # shapes the thin route takes
            args = (8, k, n, gs) if mod is i4 else (8, k, n)
            assert mod._checked_route(*args, "thin") == "thin"
    src = (_build.CSRC_DIR / "qmm_thin.cuh").read_text()
    for mt in (1, 2, 4, 8, 16):
        assert f"launch_mt<P, {mt}, kFast>" in src
    # thin_path mirrors the C entries' conditions for the TMA path
    conditions = {"nf4_matmul": "const bool fast = N % 32 == 0;",
                  "int8_matmul": "const bool fast = K % 8 == 0 && N % 16 == 0;",
                  "int4_matmul": "K % 8 == 0 && N % 16 == 0 && gs >= 16 && "
                                 "(gs & (gs - 1)) == 0;"}
    for name, cond in conditions.items():
        text = " ".join(_build.source_path(name).read_text().split())
        assert cond in text, name


def test_chip_smoke_thin_helpers():
    """chip_smoke's thin checks on the CPU: the planted faults change the
    weight the plain version computes with, the int8 unit-row target is
    ``q * scale``, and every format's decode profile keys name the thin
    policy and the wgmma one."""
    cs = _chip_smoke()
    rng = np.random.default_rng(13)
    w = torch.from_numpy(rng.normal(0, 0.02, (128, 64)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (8, 128)).astype(np.float32))
    for fmt in cs.FWD_FORMATS:
        _, plain, route_of = cs.fwd_op(fmt)
        t = cs.thin_weight(fmt, w, 32)
        good = plain(x, t, torch.float32)
        bad = plain(x, cs.thin_fault(fmt, t), torch.float32)
        assert cs._rel(bad, good)[1] > cs.KERNEL_TOL, fmt
        # unit rows read the codec's weights exactly on the plain path too
        rows = [0, 63, 64, 127]
        e = torch.zeros(len(rows), 128)
        e[torch.arange(len(rows)), torch.tensor(rows)] = 1
        want = cs.thin_codec_weights(fmt, t)[rows]
        assert torch.equal(plain(e, t, torch.float32), want), fmt
        assert route_of(cs.MAX_SLOTS, 4096, 4096) == "thin"
        keys = cs.ROUTE_KERNEL_KEYS[f"{fmt}_matmul"]
        assert keys == (cs.THIN_POLICIES[fmt],
                        cs.THIN_POLICIES[fmt].replace("Thin", "Fwd"))
    t8 = cs.thin_weight("int8", w)
    assert torch.equal(cs.thin_codec_weights("int8", t8),
                       t8.q.float() * t8.scale)
