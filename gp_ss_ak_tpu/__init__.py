"""gp_ss_ak_tpu — a JAX Gaussian-process inference engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
GP_SS_AK reference (C++/Armadillo): anisotropic
exponential-kernel GP regression for ore-grade estimation, with

- symmetric standardization of inputs/targets (the "SS"),
- the anisotropic exponential kernel family (the "AK") plus RBF,
  exponential, bias and white-noise kernels and additive composites,
- exact Gaussian / warped-Gaussian marginal likelihood + gradients
  (via jax.grad; the reference's hand-derived gradients are used as a
  correctness oracle in tests, not as code),
- bound-constrained L-BFGS-B / SCG hyperparameter optimization,
- posterior mean/variance serving, Gauss-Hermite warped predictions,
- a matrix-free streamed Gram product (a Triton kernel on the GPU)
  for N past the dense memory wall,
- mesh-sharded large-N inference (distributed kernel build + block
  Cholesky over jax.sharding meshes),
- fully Bayesian hyperposteriors (HMC/NUTS) with vmapped chains, and
- batched multi-deposit GP ensembles.

Everything under ``jit`` is pure-functional over immutable arrays; the
reference's mutable N x N buffers + dirty flags (GP_Utils.h:306-379)
have no equivalent here by design.
"""

__version__ = "0.1.0"

from gp_ss_ak_tpu import kernels, inference, data, optim  # noqa: F401
from gp_ss_ak_tpu.model import GPModel, load_model, save_model  # noqa: F401
