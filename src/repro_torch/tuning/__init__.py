"""Architecture-aware autotuning for Hopper (the paper's empirical loop).

The port's ``repro.tuning``.  The paper's headline result (Sections 3.3,
5.1–5.2) is that the *measured* per-class optima of the blocking
parameters and of the big:LITTLE ratio knob beat the analytical
derivation.  This package closes the same loop on the card:

  candidates.py  — the compiled CUDA tile shapes that fit each class's
                   shared memory under its kernel's ring, seeded by the
                   analytical optimum of ``derive_block_config``.
  measure.py     — score candidates: a roofline cost model over the SM
                   waves (tests, the prefilter) or the kernels' device time
                   from CUDA events (``gemm_cuda`` / ``gemm_cuda_lean``).
  cache.py       — versioned on-disk JSON cache keyed by ``(class spec,
                   dtype, shape bucket)`` with atomic writes.
  ratio.py       — per-class throughput-ratio calibration (Section 5.2.2)
                   feeding ``AsymmetricMesh.from_calibration``.
  tune.py        — the CLI: ``python -m repro_torch.tuning.tune --spec h100
                   --backend cost-model --shapes 512x512x512``.

Consumption is opt-in: set ``REPRO_TORCH_TUNING_CACHE=/path/to/cache.json``
and the control trees and execution contexts take the tuned blocks (and
recorded kernel variants); unset, the analytical derivation is used.
"""

from repro_torch.tuning.cache import TuningCache, shape_bucket_key
from repro_torch.tuning.candidates import SPECS, analytical_config, enumerate_candidates
from repro_torch.tuning.measure import cost_model_time, make_backend
from repro_torch.tuning.ratio import Calibration, calibrate_class_ratios, sweep_ratio_knob

__all__ = [
    "TuningCache",
    "shape_bucket_key",
    "SPECS",
    "analytical_config",
    "enumerate_candidates",
    "cost_model_time",
    "make_backend",
    "Calibration",
    "calibrate_class_ratios",
    "sweep_ratio_knob",
]
