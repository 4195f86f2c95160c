"""PyTorch port: the continuous-batching engine against the JAX engine.

Both engines serve the committed HF fixture in f32 (compute and KV cache;
the JAX engine's default KV dtype is bf16, so it is set explicitly) in the
contiguous layout with two slots, and take three greedy prompts of
different lengths at once, so one slot is reused. The greedy token ids
must be identical and the finish reasons must agree.

The same holds for the tiny NF4 model of ``tests/test_torch_qwen3.py``
served through both packages' ``QuantizedModel`` (JAX: Pallas kernel in
interpret mode; port: the kernel's plain version on the CPU). The two
differ by bf16 rounding noise only (see that file), far below the gap
between the top two logits of these greedy streams.

Seeded sampling cannot be compared token for token: the port draws from a
``torch.Generator`` and the JAX engine from ``jax.random``, which give
different numbers from the same seed. It is checked by distribution: with
``top_k=5`` every sampled token lies in the top 5 of the port's own
logits at its position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_fixture_both, numpy_params, tiny_port_model

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.quant import nf4 as jax_nf4
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu.serve.quantized import QuantizedModel as JaxQuantized
from llm_in_practise_tpu_torch.models.convert import params_from_jax
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel

PROMPTS = [[3, 17, 42, 9, 88, 5, 61], [120, 7, 7, 33], [11, 90, 54, 2, 150,
                                                        19, 64, 8, 31, 77]]
NEW_TOKENS = 12


def _run_port(model, eos_id, prompts, params):
    eng = InferenceEngine(model, max_slots=2, cache_len=64, eos_id=eos_id,
                          cache_dtype=torch.float32)
    reqs = [eng.submit(p, params) for p in prompts]
    while eng.step():
        pass
    return [(r.result(), r.finish_reason) for r in reqs]


def _run_jax(model, params, eos_id, prompts):
    eng = JaxEngine(model, params, max_slots=2, cache_len=64, eos_id=eos_id,
                    cache_dtype=jnp.float32, kv_layout="contiguous")
    reqs = [eng.submit(p, JaxParams(greedy=True, max_tokens=NEW_TOKENS))
            for p in prompts]
    while eng.step():
        pass
    out = [(r.result(), r.finish_reason) for r in reqs]
    eng.stop()
    return out


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


def test_greedy_tokens_identical_to_jax_engine(fixture_models):
    jmodel, jparams, pmodel = fixture_models
    greedy = SamplingParams(greedy=True, max_tokens=NEW_TOKENS)
    # pick an EOS that one stream reaches mid-way, so both finish reasons
    # ("stop" on EOS, "length" on the budget) occur
    free = _run_port(pmodel, None, PROMPTS, greedy)
    eos = free[1][0][4]
    port = _run_port(pmodel, eos, PROMPTS, greedy)

    jax_out = _run_jax(jmodel, jparams, eos, PROMPTS)

    assert [t for t, _ in port] == [t for t, _ in jax_out]
    assert [f for _, f in port] == [f for _, f in jax_out]
    reasons = {f for _, f in port}
    assert reasons == {"stop", "length"}, reasons
    assert all(len(t) == NEW_TOKENS for t, f in port if f == "length")


def test_nf4_greedy_tokens_identical_to_jax_engine():
    jmodel = JaxQwen3(jax_qwen3_config(
        512, hidden_size=256, intermediate_size=512, n_head=4, n_kv_head=2,
        head_dim=128, n_layer=2, compute_dtype="float32", max_seq_len=64))
    qtree = jax_nf4.quantize_tree(
        numpy_params(jmodel, seed=7),
        lambda p, leaf: p.startswith("block_") and p.endswith("kernel"))
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    pq = QuantizedModel(
        Qwen3(cfg, device="meta"),
        params_from_jax(jax.tree.map(np.asarray, qtree), cfg),
        compute_dtype=torch.float32, device="cpu")
    port = _run_port(pq, None, PROMPTS,
                     SamplingParams(greedy=True, max_tokens=NEW_TOKENS))
    jax_out = _run_jax(JaxQuantized(jmodel, compute_dtype=jnp.float32),
                       qtree, None, PROMPTS)
    assert port == jax_out
    assert all(f == "length" and len(t) == NEW_TOKENS for t, f in port)


def test_seeded_sampling_stays_in_top_k():
    model = tiny_port_model(256, seed=3)
    params = SamplingParams(temperature=1.0, top_k=5, max_tokens=10)
    outs = _run_port(model, None, PROMPTS[:2], params)
    for prompt, (toks, _) in zip(PROMPTS, outs):
        assert len(toks) == 10
        seq = torch.tensor([prompt + toks])
        with torch.inference_mode():
            logits = model(seq)[0]
        for j, tok in enumerate(toks):
            top5 = torch.topk(logits[len(prompt) - 1 + j], 5).indices.tolist()
            assert tok in top5
    # the same seed replays the same draws
    assert _run_port(model, None, PROMPTS[:2], params) == outs


def test_slot_reuse_and_budget_bookkeeping():
    model = tiny_port_model(256, seed=4)
    eng = InferenceEngine(model, max_slots=1, cache_len=16,
                          cache_dtype=torch.float32)
    reqs = [eng.submit([1, 2, 3], SamplingParams(greedy=True, max_tokens=3)),
            eng.submit(list(range(40)), SamplingParams(greedy=True,
                                                      max_tokens=50))]
    while eng.step():
        pass
    assert len(reqs[0].result()) == 3 and reqs[0].finish_reason == "length"
    # the long prompt is cropped to cache_len - 2 and stops on cache room
    assert len(reqs[1].prompt_ids) == 14
    assert reqs[1].finish_reason == "cache"
    assert eng.slot_req == [None]


@pytest.mark.parametrize("knob", [
    dict(prefix_cache=True), dict(chunked_prefill=64), dict(decode_steps=4),
    dict(speculative_k=4), dict(kv_layout="paged"), dict(mesh=object()),
    dict(adapter_registry=object()), dict(max_queue=4)])
def test_unported_engine_knobs_raise(knob):
    model = tiny_port_model(64, seed=5)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        InferenceEngine(model, **knob)


def test_background_thread_serves_and_stops():
    model = tiny_port_model(64, seed=6)
    eng = InferenceEngine(model, max_slots=2, cache_len=32,
                          cache_dtype=torch.float32)
    eng.start()
    try:
        want = [eng.submit([5, 6, 7], SamplingParams(greedy=True,
                                                     max_tokens=4))
                for _ in range(3)]
        got = [r.result() for r in want]
        assert all(g == got[0] and len(g) == 4 for g in got)
        assert all(r.ttft_s is not None and r.tpot_s is not None
                   for r in want)
    finally:
        eng.stop()
    assert not eng.is_alive()
    np.testing.assert_array_equal(eng.slot_ready, [False, False])
