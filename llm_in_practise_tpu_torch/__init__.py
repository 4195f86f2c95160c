"""PyTorch/CUDA port of ``llm_in_practise_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``core/``, ``quant/``, ``ops/``, ``models/``, ``infer/``, ``serve/``,
``data/``) and imports ``torch``, never ``jax`` and nothing of the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (:func:`llm_in_practise_tpu_torch.core.device.resolve_device`).

Importing the package imports no submodule: the CUDA kernels build at
their first call, never at import.
"""
