"""montecarlo_tpu_torch — the PyTorch/CUDA port of ``montecarlo_tpu``.

Same process protocol, the same counter-keyed draw streams (seed, stream,
global path id, draw index) and the same fixed-block statistics as the JAX
package, written in PyTorch.  The kernels on the pricing path are CUDA C++
for Hopper (``csrc/``), built on first use; on a CPU tensor every kernel
wrapper runs its plain PyTorch version instead.

Entry points: ``python -m montecarlo_tpu_torch price ...`` and
:mod:`montecarlo_tpu_torch.engine`.
"""
