"""PyTorch/CUDA port of ``controllable_agent_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference: every module here mirrors the
module of the same path there and is tested against it on the same inputs
(``tests/test_torch_*.py``). The port imports ``torch`` and nothing of JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (``utils.device``).
"""
