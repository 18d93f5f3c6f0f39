"""Registry contract checks: import the port, verify the tables.

These checks import :mod:`repro_torch.core.execution` and
:mod:`repro_torch.kernels.gemm` and inspect the dispatch tables *without
launching any kernel* — pure dictionary closure properties:

* **RPR101** — the violations
  :func:`repro_torch.core.execution.validate_registry` reports:
  ``BACKENDS`` / ``BACKEND_OPS`` agreement, a registered ``PLAIN_TWIN``
  (the plain PyTorch route the CPU parity tests walk) for every entry,
  ``LEAN_VARIANTS`` mapping a pipelined entry to a one-stage one, and
  ``GEMM_KERNELS`` naming only kernel (non-twin) GEMM entries.

* **RPR102** — op families closed under
  :func:`~repro_torch.core.execution.align_backend_family`: remapping any
  family member onto any other member's family (kernel or plain) must
  land inside the same family and inside the table.  This is what lets a
  tuning cache recorded on the card be replayed by a tree built on the
  plain versions (and back) without a name ever escaping the registry.
"""

from __future__ import annotations

from repro_torch.analysis.diagnostics import Diagnostic

# Where registry findings anchor: the tables live here.
_EXECUTION = "src/repro_torch/core/execution.py"


def check_registry() -> list[Diagnostic]:
    from repro_torch.core import execution as X

    diags = [
        Diagnostic(code="RPR101", path=_EXECUTION, line=1, message=p)
        for p in X.validate_registry()
    ]

    # Family closure under align_backend_family.  Skip if the base tables
    # are already broken (RPR101 reported above): closure errors would
    # only repeat the same root cause.
    if diags:
        return diags
    families: dict[str, list[str]] = {}
    for name, op in X.BACKEND_OPS.items():
        families.setdefault(op, []).append(name)
    for op, members in families.items():
        for variant in members:
            for requested in members:
                try:
                    mapped = X.align_backend_family(variant, requested)
                except Exception as e:  # a raise is itself a closure break
                    diags.append(
                        Diagnostic(
                            code="RPR102",
                            path=_EXECUTION,
                            line=1,
                            message=(
                                f"align_backend_family({variant!r}, "
                                f"{requested!r}) raised {type(e).__name__}: {e}"
                            ),
                        )
                    )
                    continue
                if mapped not in X.BACKENDS or X.BACKEND_OPS[mapped] != op:
                    diags.append(
                        Diagnostic(
                            code="RPR102",
                            path=_EXECUTION,
                            line=1,
                            message=(
                                f"{op} family not closed: "
                                f"align_backend_family({variant!r}, "
                                f"{requested!r}) = {mapped!r} escapes the "
                                "family"
                            ),
                        )
                    )
    return diags


__all__ = ["check_registry"]
