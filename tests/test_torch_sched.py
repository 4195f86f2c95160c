"""PyTorch port: the engine's scheduling paths against the JAX engine.

Both engines serve the committed HF fixture in f32 (compute and KV) in
the contiguous layout, 4 slots of 64 positions, chunked prefill 8 and
decode blocks of up to 4, under the mixed load of
``tests/test_mixed_step.py``: two short prompts decode while a 30-token
prompt chunk-prefills. They step in lockstep; after every step the host
slot tables agree, every ready row's KV below its length and every
mid-prefill row's KV below its watermark agree at 1e-5 (a row sent to
index 0 by a decode would fail here: the block's garbage rows would land
over its prompt), and at the end the greedy tokens and finish reasons are
identical. Cases: the fused mixed step on and off, ``decode_steps`` 1 and
``prefill_budget`` 2.

The port's own counters show one dispatch per step under mixed load with
the fused step and two without it; the block planner equals the JAX one
on a grid of all its arguments; the sampler with a host-given all-greedy
flag and a supplied noise tensor equals its default path on the same
draws; the scheduling knobs are validated as in JAX; and the launch
counters replay a capture's delta as a CUDA graph replay needs.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_fixture_both, tiny_port_model

from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu.serve.mixed_step import (
    plan_decode_block as jax_plan_decode_block,
)
from llm_in_practise_tpu_torch.infer.sampling import sample_token_batched
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.mixed_step import plan_decode_block

SHORT = ([3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8])
LONG = [(i * 7 + 3) % 160 for i in range(30)]   # 30 tokens: 4 chunks of 8
ENGINE = dict(max_slots=4, cache_len=64, chunked_prefill=8, decode_steps=4)
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


def _submit_short(eng, params):
    return [eng.submit(p, params) for p in SHORT]


def _watermarks(eng) -> np.ndarray:
    """Rows of valid KV per slot: a ready slot's length, a mid-prefill
    slot's watermark, 0 for a free slot."""
    valid = np.zeros((eng.max_slots,), np.int64)
    for s, req in enumerate(eng.slot_req):
        if req is not None and eng.slot_ready[s]:
            valid[s] = eng.slot_len[s]
    for s, st in eng.slot_prefill.items():
        valid[s] = st["done"]
    return valid


def _assert_same_state(port, jeng, where):
    assert [r is None for r in port.slot_req] == \
        [r is None for r in jeng.slot_req], where
    assert {s: st["done"] for s, st in port.slot_prefill.items()} == \
        {s: st["done"] for s, st in jeng.slot_prefill.items()}, where
    valid = _watermarks(port)
    np.testing.assert_array_equal(valid, _watermarks(jeng), err_msg=where)
    for s in range(port.max_slots):
        if port.slot_req[s] is not None and port.slot_ready[s]:
            assert port.slot_len[s] == jeng.slot_len[s], where
            assert port.slot_last_token[s] == jeng.slot_last_token[s], where
    for i, (pl, jl) in enumerate(zip(port.cache, jeng.cache)):
        for key in ("k", "v"):
            got = pl[key].numpy()
            want = np.asarray(jl[key])
            for s in range(port.max_slots):
                v = int(valid[s])
                np.testing.assert_allclose(
                    got[s, :v], want[s, :v], rtol=KV_TOL, atol=KV_TOL,
                    err_msg=f"{where}: layer {i} {key} slot {s}")


@pytest.mark.parametrize("case", [
    dict(), dict(mixed_step=False), dict(decode_steps=1),
    dict(prefill_budget=2)], ids=["fused", "sequential", "decode_steps_1",
                                  "prefill_budget_2"])
def test_mixed_load_matches_jax_engine(fixture_models, case):
    jmodel, jparams, pmodel = fixture_models
    kw = {**ENGINE, **case}
    port = InferenceEngine(pmodel, cache_dtype=torch.float32, **kw)
    jeng = JaxEngine(jmodel, jparams, cache_dtype=jnp.float32,
                     kv_layout="contiguous", **kw)
    short_p = SamplingParams(greedy=True, max_tokens=24)
    long_p = SamplingParams(greedy=True, max_tokens=8)
    hp = _submit_short(port, short_p)
    hj = _submit_short(jeng, JaxParams(greedy=True, max_tokens=24))
    assert port.step() and jeng.step()          # admission, first block
    hp.append(port.submit(LONG, long_p))
    hj.append(jeng.submit(LONG, JaxParams(greedy=True, max_tokens=8)))
    mid_prefill_steps = 0
    for i in itertools.count():
        assert i < 64, "the load never drained"
        busy = port.step()
        assert busy == jeng.step(), f"step {i}"
        mid_prefill_steps += bool(port.slot_prefill)
        _assert_same_state(port, jeng, f"step {i}")
        if not busy:
            break
    jeng.stop()
    assert mid_prefill_steps >= 1   # KV was compared mid-prefill
    assert [r.result() for r in hp] == [r.result() for r in hj]
    assert [r.finish_reason for r in hp] == [r.finish_reason for r in hj]
    assert [len(r.output_ids) for r in hp] == [24, 24, 8]
    assert port.mixed_blocks == jeng.mixed_blocks
    assert port.multi_blocks == jeng.multi_blocks
    assert port.multi_steps_total == jeng.multi_steps_total
    assert (port.mixed_blocks > 0) == kw.get("mixed_step", True)


def _run_dispatch_load(mixed_step):
    model = tiny_port_model(160, seed=2)
    eng = InferenceEngine(model, cache_dtype=torch.float32,
                          mixed_step=mixed_step, **ENGINE)
    h = _submit_short(eng, SamplingParams(greedy=True, max_tokens=64))
    eng.step()
    assert all(r.first_token_time is not None for r in h)
    hl = eng.submit(LONG, SamplingParams(greedy=True, max_tokens=8))
    per_step = []
    while hl.first_token_time is None:
        gen_before = [r.n_generated for r in h]
        eng.step()
        assert len(per_step) < 12, "long prompt never activated"
        if eng.slot_prefill:                      # still mid-prefill
            per_step.append(eng.last_step_dispatches)
            if mixed_step:   # the block kept n > 1 while prefill ran
                assert [r.n_generated for r in h] == \
                    [g + eng.decode_steps for g in gen_before]
    return eng, per_step


def test_one_dispatch_per_step_under_mixed_load():
    eng, per_step = _run_dispatch_load(mixed_step=True)
    assert len(per_step) >= 2 and set(per_step) == {1}
    assert eng.mixed_blocks >= len(per_step)
    eng, per_step = _run_dispatch_load(mixed_step=False)
    assert len(per_step) >= 2 and min(per_step) >= 2
    assert eng.mixed_blocks == 0


def test_plan_decode_block_equals_jax():
    for ds, q, soonest, chunk, head in itertools.product(
            (1, 2, 4, 6, 8), (0, 2), (None, 0, 1, 3, 5, 9),
            (None, 1, 3, 8), (None, -2, 0, 1, 5, 7, 16)):
        kw = dict(decode_steps=ds, queue_depth=q, soonest_finish=soonest,
                  chunk=chunk, prefill_headroom=head)
        n = plan_decode_block(**kw)
        assert n == jax_plan_decode_block(**kw), kw
        # one captured graph per length: decode_steps or a power of two
        # below it
        assert n == ds or (n < ds and n & (n - 1) == 0), kw


def test_sampler_host_flag_and_noise_equal_default_path():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((5, 50)).astype(np.float32))
    params = dict(temperature=torch.tensor([1.0, 0.7, 1.3, 1.0, 0.5]),
                  top_k=torch.tensor([0, 5, 0, 3, 10]),
                  top_p=torch.tensor([1.0, 1.0, 0.8, 0.9, 0.0]),
                  greedy=torch.tensor([False, False, True, False, False]))
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    want = sample_token_batched(gen, logits, **params)
    gen.set_state(state)
    noise = torch.rand((5, 50), generator=gen)
    got = sample_token_batched(None, logits, **params, all_greedy=False,
                               noise=noise)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    greedy = dict(params, greedy=torch.ones(5, dtype=torch.bool))
    torch.testing.assert_close(
        sample_token_batched(None, logits, **greedy, all_greedy=True),
        sample_token_batched(gen, logits, **greedy), rtol=0, atol=0)


@pytest.mark.parametrize("knob", [
    dict(chunked_prefill=0), dict(decode_steps=0), dict(prefill_budget=0),
    dict(max_queue=0), dict(queue_timeout_s=0.0)])
def test_scheduling_knobs_are_validated_as_in_jax(knob):
    """The JAX engine's bounds (``engine.py:506-555, 719-761``)."""
    with pytest.raises(ValueError, match=next(iter(knob))):
        InferenceEngine(tiny_port_model(64, seed=5), **knob)


def test_launch_counts_replay_bookkeeping():
    """What a graph capture does with the kernel counters: the capture's
    delta is recorded, the counts go back (a capture launches nothing),
    and every replay adds the delta once."""
    from llm_in_practise_tpu_torch.ops import launch_count
    from llm_in_practise_tpu_torch.ops.flash_attention import flash_forward
    from llm_in_practise_tpu_torch.ops.nf4_matmul import nf4_matmul

    before = launch_count.snapshot()
    assert nf4_matmul in before and flash_forward in before
    for _ in range(3):
        launch_count.count(nf4_matmul, "thin")
    launch_count.count(nf4_matmul, "wgmma")
    launch_count.count(flash_forward)
    after = launch_count.snapshot()
    delta = launch_count.delta(before, after)
    assert delta[nf4_matmul] == (4, {"wgmma": 1, "thin": 3})
    assert delta[flash_forward] == (1, {})
    launch_count.restore(before)
    assert launch_count.snapshot() == before
    launch_count.add(delta)
    launch_count.add(delta)
    assert nf4_matmul.launches == before[nf4_matmul][0] + 8
    assert nf4_matmul.launches_by_route["thin"] == \
        before[nf4_matmul][1]["thin"] + 6
    assert flash_forward.launches == before[flash_forward][0] + 2
    launch_count.restore(before)
