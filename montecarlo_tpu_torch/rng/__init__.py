"""Counter-based Threefry RNG, the normal/uniform variates built on it, and
randomized Sobol QMC."""

from montecarlo_tpu_torch.rng.threefry import (  # noqa: F401
    MASK32,
    as_words,
    key_from_seed,
    random_bits,
    threefry2x32,
)
from montecarlo_tpu_torch.rng.normal import (  # noqa: F401
    boxmuller_pair,
    categorical_draw,
    exp32,
    index_from_uniform,
    log32,
    ndtri32,
    normal_draw,
    normal_matrix,
    normal_pair,
    uniform_draw,
    uniform_from_bits,
    uniform_pair,
)
from montecarlo_tpu_torch.rng.sobol import (  # noqa: F401
    SobolBridgeDeviceSampler,
    SobolBridgeKernelSampler,
    SobolDeviceSampler,
    brownian_bridge_matrix,
    direction_numbers,
    sobol_bits,
)
