from .hmc import HMCState, HMCInfo, hmc_kernel, init_state, leapfrog
from .nuts import NUTSInfo, nuts_kernel
from .logdensity import (flow_preconditioned, PreconditionedTarget,
                         FlowPushforwardTarget)
from .sample import sample, window_adaptation, run_chains, WarmupResult
from .adaptation import (
    da_init, da_update, welford_init, welford_update, welford_update_batch,
    welford_variance, build_schedule,
)
from .chees import (
    chees_sample, chees_warmup, run_chains_chees, hmc_proposal_kernel,
    ChEESWarmupResult, ChEESSampleStats,
)
from .diagnostics import (
    ess, ess_per_dim, split_rhat, split_rhat_per_dim, bfmi,
    rank_normalized_rhat, rank_normalized_rhat_per_dim, bulk_ess, tail_ess,
    pareto_khat,
)

__all__ = [
    "HMCState", "HMCInfo", "hmc_kernel", "init_state", "leapfrog",
    "NUTSInfo", "nuts_kernel",
    "flow_preconditioned", "PreconditionedTarget",
    "sample", "window_adaptation", "run_chains", "WarmupResult",
    "da_init", "da_update", "welford_init", "welford_update",
    "welford_update_batch", "welford_variance", "build_schedule",
    "FlowPushforwardTarget",
    "chees_sample", "chees_warmup", "run_chains_chees",
    "hmc_proposal_kernel", "ChEESWarmupResult", "ChEESSampleStats",
    "ess", "ess_per_dim", "split_rhat", "split_rhat_per_dim", "bfmi",
    "rank_normalized_rhat", "rank_normalized_rhat_per_dim",
    "bulk_ess", "tail_ess", "pareto_khat",
]
