"""enflows_tpu: a JAX probabilistic-inference engine.

A JAX/XLA framework with the capabilities of
bat/EuclidianNormalizingFlows.jl (reference mounted at /root/reference —
studied for behavior, not translated): a composable trainable-bijector
algebra with analytic log-abs-det-Jacobians and exact parameter-sharing
inverses, maximum-likelihood whitening and flow-VI trainers, flow-
preconditioned HMC/NUTS with windowed warmup, tempered SMC with learned
annealing transports, and multi-device sharding over `jax.sharding.Mesh`.
"""

from . import bijectors, distributions

from .bijectors import (
    Bijector, Chain, Identity, compose, invert, forward_and_ladj,
    ScaleShift, CenterStretch, CenterContract, Johnson, JohnsonInv,
    Householder, AffineCoupling, Permute, init_affine_coupling,
    coupling_stack, RQSplineCoupling, ElementwiseRQSpline,
    init_rq_spline_coupling, init_elementwise_rq_spline,
    spline_coupling_stack,
)
from .distributions import (
    FlowDistribution, JohnsonSU, std_normal_logpdf, std_normal_logpdf_sum,
)
from .utils.pytree import param_dtype
from .infer import (
    infer, InferenceResult, summarize_draws, default_flow_template,
    coupling_flow_template,
)

__version__ = "0.1.0"
