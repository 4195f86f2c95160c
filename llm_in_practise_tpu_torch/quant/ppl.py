"""Perplexity evaluation with the quantization acceptance gate.

Port of ``llm_in_practise_tpu/quant/ppl.py``: teacher-forced next-token
log-likelihood of held-out texts, one PPL per text, their **mean** as the
model's PPL (the reference's aggregation, not a corpus NLL), gated
against a threshold (the reference's FP16 model scores about 8.19 and a
quantized one passes below 9.0).

``apply_fn(params, input_ids) -> logits`` keeps the JAX shape. In the
port ``params`` is a flat state for a model's :meth:`~..models.qwen3.
Qwen3.apply` (``lambda state, x: model.apply(state, x)``), or anything
the function closes over, e.g. ``lambda _, x: served_model(x)`` for a
packed model behind the serving kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PPLReport:
    mean_ppl: float
    per_sample_ppl: list[float]
    n_tokens: int
    threshold: float
    passed: bool

    def summary(self) -> str:
        verdict = (
            "within acceptance threshold (lossless for practical purposes)"
            if self.passed else "exceeds threshold — recalibrate"
        )
        return (
            f"mean PPL {self.mean_ppl:.3f} over {self.n_tokens} tokens "
            f"(threshold {self.threshold:.2f}): {verdict}"
        )


def _nll_sums(logits: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (sum NLL, token count) from (B, L, V) logits, in f32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tok_ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return -(tok_ll * mask).sum(dim=-1), mask.sum(dim=-1)


def evaluate_ppl(apply_fn, params, token_batches, *,
                 threshold: float = 9.0) -> PPLReport:
    """Score next-token PPL over ``(input_ids, target_ids, mask)`` batches
    (:func:`make_batches`; mask 1 = a scored position)."""
    sums, counts = [], []
    with torch.no_grad():
        for x, y, m in token_batches:
            s, c = _nll_sums(apply_fn(params, x), y, m)
            sums.append(s.cpu().numpy())
            counts.append(c.cpu().numpy())
    sums = np.concatenate(sums)
    counts = np.concatenate(counts)
    valid = counts > 0
    per_sample = np.exp(sums[valid] / counts[valid])
    mean_ppl = float(np.mean(per_sample))
    return PPLReport(
        mean_ppl=mean_ppl,
        per_sample_ppl=[float(p) for p in per_sample],
        n_tokens=int(counts.sum()),
        threshold=threshold,
        passed=mean_ppl < threshold,
    )


def make_batches(sequences, *, batch_size: int = 8, max_len: int = 512,
                 device=None) -> list[tuple[torch.Tensor, ...]]:
    """Raw id sequences -> right-padded ``(input, target, mask)``
    next-token batches (int64 ids, f32 mask) on ``device`` (default the
    CPU); sequences shorter than 2 ids are dropped."""
    seqs = [list(map(int, s))[: max_len + 1] for s in sequences
            if len(s) >= 2]
    out = []
    for i in range(0, len(seqs), batch_size):
        chunk = seqs[i: i + batch_size]
        longest = max(len(s) for s in chunk)
        x = np.zeros((len(chunk), longest - 1), np.int64)
        y = np.zeros((len(chunk), longest - 1), np.int64)
        m = np.zeros((len(chunk), longest - 1), np.float32)
        for j, s in enumerate(chunk):
            arr = np.asarray(s, np.int64)
            x[j, : len(s) - 1] = arr[:-1]
            y[j, : len(s) - 1] = arr[1:]
            m[j, : len(s) - 1] = 1.0
        out.append(tuple(torch.from_numpy(a).to(device) for a in (x, y, m)))
    return out


def compare_quantized(apply_fn, params_fp, params_q, token_batches, *,
                      threshold: float = 9.0) -> dict:
    """FP-vs-quantized PPL: the reference's two-row verdict table."""
    fp = evaluate_ppl(apply_fn, params_fp, token_batches, threshold=threshold)
    q = evaluate_ppl(apply_fn, params_q, token_batches, threshold=threshold)
    return {
        "fp_ppl": fp.mean_ppl,
        "quant_ppl": q.mean_ppl,
        "degradation": q.mean_ppl - fp.mean_ppl,
        "passed": q.passed,
        "report": q,
    }
