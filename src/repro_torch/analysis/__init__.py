"""The port's static verifier (``python -m repro_torch.analysis``).

The reference's analyzer (``repro.analysis``) read for the port: the same
diagnostic catalogue (``RPR000``–``RPR202``), checked against the port's
own registries and rules:

* in-place state discipline (RPR001/RPR002: read-after-update and copy
  pins, where the reference checks donation; ``donation``),
* rebuild hazards (RPR003: ``torch.compile`` / ``torch.jit`` / the kernel
  library loader in a loop body),
* ContextVar token discipline (RPR004),
* backend-vocabulary drift against the port's live registry (RPR005),
* dispatch-table closure (RPR101/RPR102),
* shared-memory / compiled-tile / shared-bk block contracts (RPR201),
* bench-artifact schema (RPR202).

Suppressions read ``# repro_torch: noqa=RPR0xx -- reason``, so the two
analyzers never read each other's: a port line the reference's analyzer
must skip carries ``# repro: noqa=...`` and is still checked here.
"""

from repro_torch.analysis.cli import analyze_file, analyze_paths, main
from repro_torch.analysis.diagnostics import CODES, Diagnostic

__all__ = ["CODES", "Diagnostic", "analyze_file", "analyze_paths", "main"]
