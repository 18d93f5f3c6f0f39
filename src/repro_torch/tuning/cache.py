"""Persistent on-disk tuning cache (the port's ``repro.tuning.cache``).

A single JSON file maps ``(class spec name, dtype, M/K/N shape bucket)`` to
the tuned ``BlockConfig`` plus provenance (the winning kernel variant, the
scorer, measured/estimated seconds, the analytical baseline it beat).
Shape dims are bucketed by rounding up to ``H100.align`` = 16, the
alignment the Hopper derivation and ``validate_block_config`` round M and N
to, so problem sizes that pad identically share an entry.  (The
reference's 128-lane buckets would alias the decode step's M = 12 onto
M = 128, whose blocks the kernel rejects at M = 12.)

Format (``CACHE_VERSION`` guards schema drift; a version mismatch
invalidates the whole file and the caller falls back to the analytical
derivation):

.. code-block:: json

    {
      "version": 1,
      "entries": {
        "h100/bfloat16/16x2048x2048": {
          "bm": 64, "bk": 256, "bn": 32,
          "dtype_bytes": 2, "acc_bytes": 4,
          "backend": "cuda",
          "measured_with": "wallclock",
          "time_s": 1.4e-5, "analytical_time_s": 1.5e-5,
          "objective": "perf",
          "shape": [12, 2048, 2048]
        }
      }
    }

``"backend"`` records the winning kernel variant (``"cuda"`` or the
one-stage ``"cuda_lean"``); consumers treat any value outside the GEMM
dispatch entries as "no variant recorded".  ``"objective"`` records what
the search minimized; the tuner treats an entry tuned under another
objective as a miss.

The port reads its own environment variables, ``REPRO_TORCH_TUNING_CACHE``
and ``REPRO_TORCH_TUNING_SPEC`` (default ``h100``), never the reference's:
both packages may share one process (the parity tests), and a Hopper
cache must not reach the TPU kernels, nor a TPU cache the CUDA ones.

Writes are atomic and durable (``repro_torch.util.atomic``: tempfile +
fsync + ``os.replace``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Optional

from repro_torch.core.blocking import (
    H100,
    PIPELINE_STAGES,
    BlockConfig,
    HopperClassSpec,
    _round_up,
    derive_block_config,
)
from repro_torch.util.atomic import atomic_write_json

log = logging.getLogger(__name__)

CACHE_VERSION = 1
ENV_VAR = "REPRO_TORCH_TUNING_CACHE"
ENV_SPEC_VAR = "REPRO_TORCH_TUNING_SPEC"
DEFAULT_PATH = os.path.join("artifacts", "tuning", "torch_cache.json")


def _bucket(dim: int) -> int:
    """Dim rounded up to the derivation's alignment (min one step).

    A tuned block never exceeds its problem rounded up to this alignment
    (``validate_block_config``), so every problem in a bucket can run the
    bucket's entry.
    """

    return max(H100.align, _round_up(dim, H100.align))


def shape_bucket_key(spec_name: str, dtype_name: str, m: int, k: int, n: int) -> str:
    return f"{spec_name}/{dtype_name}/{_bucket(m)}x{_bucket(k)}x{_bucket(n)}"


@dataclasses.dataclass
class TuningCache:
    """In-memory view of one cache file; ``save()`` persists atomically."""

    path: Optional[str] = None
    entries: dict[str, dict[str, Any]] = dataclasses.field(default_factory=dict)
    # (spec, dtype, m, k, n) -> (config, recorded backend): what every GEMM
    # call asks, without re-formatting its bucket key.
    _lookups: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    # -- IO ----------------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        """Read a cache file; missing/corrupt/version-mismatched → empty."""

        if not os.path.exists(path):
            return cls(path=path)
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            log.warning("tuning cache %s unreadable (%s); starting empty", path, e)
            return cls(path=path)
        if not isinstance(raw, dict):
            log.warning(
                "tuning cache %s is not a JSON object (got %s); starting empty",
                path, type(raw).__name__,
            )
            return cls(path=path)
        if raw.get("version") != CACHE_VERSION:
            log.warning(
                "tuning cache %s has version %r != %d; invalidating",
                path, raw.get("version"), CACHE_VERSION,
            )
            return cls(path=path)
        return cls(path=path, entries=dict(raw.get("entries", {})))

    def save(self, path: Optional[str] = None) -> str:
        """Atomic durable write (tempfile in the target dir, fsync, then
        ``os.replace``)."""

        path = path or self.path
        if path is None:
            raise ValueError("TuningCache.save() needs a path")
        payload = {"version": CACHE_VERSION, "entries": self.entries}
        atomic_write_json(
            path, payload, indent=1, sort_keys=True, newline=False,
            prefix=".tuning-cache-",
        )
        self.path = path
        _memo.clear()  # the next lookup reads what was just written
        return path

    # -- entries -----------------------------------------------------------

    def put(
        self,
        spec_name: str,
        dtype_name: str,
        m: int,
        k: int,
        n: int,
        cfg: BlockConfig,
        **meta: Any,
    ) -> str:
        key = shape_bucket_key(spec_name, dtype_name, m, k, n)
        self.entries[key] = {
            "bm": cfg.bm,
            "bk": cfg.bk,
            "bn": cfg.bn,
            "dtype_bytes": cfg.dtype_bytes,
            "acc_bytes": cfg.acc_bytes,
            "shape": [m, k, n],
            **meta,
        }
        self._lookups.clear()
        return key

    def get(
        self, spec_name: str, dtype_name: str, m: int, k: int, n: int
    ) -> Optional[BlockConfig]:
        key = shape_bucket_key(spec_name, dtype_name, m, k, n)
        e = self.entries.get(key)
        if e is None:
            return None
        try:
            return BlockConfig(
                bm=int(e["bm"]),
                bk=int(e["bk"]),
                bn=int(e["bn"]),
                dtype_bytes=int(e.get("dtype_bytes", 2)),
                acc_bytes=int(e.get("acc_bytes", 4)),
            )
        except (KeyError, TypeError, ValueError) as err:
            # A malformed entry (hand-edited, truncated) is a miss, not a
            # crash on the kernel hot path.
            log.warning("tuning cache entry %s malformed (%s); ignoring", key, err)
            return None

    def lookup(
        self, spec_name: str, dtype_name: str, m: int, k: int, n: int
    ) -> tuple[Optional[BlockConfig], Optional[str]]:
        """``(get(...), the entry's raw "backend" string or None)``, memoised
        by the call's own dims."""

        key = (spec_name, dtype_name, m, k, n)
        hit = self._lookups.get(key)
        if hit is None:
            entry = self.entries.get(shape_bucket_key(spec_name, dtype_name, m, k, n)) or {}
            backend = entry.get("backend") if isinstance(entry, dict) else None
            hit = (self.get(spec_name, dtype_name, m, k, n),
                   backend if isinstance(backend, str) else None)
            self._lookups[key] = hit
        return hit

    def lookup_or_analytical(
        self,
        m: int,
        k: int,
        n: int,
        *,
        spec: HopperClassSpec = H100,
        dtype_name: str = "bfloat16",
        dtype_bytes: int = 2,
        stages: int = PIPELINE_STAGES,
    ) -> tuple[BlockConfig, bool]:
        """Tuned config on hit, analytical derivation on miss."""

        cfg = self.get(spec.name, dtype_name, m, k, n)
        if cfg is not None:
            log.debug("tuning cache hit %s", shape_bucket_key(spec.name, dtype_name, m, k, n))
            return cfg, True
        return derive_block_config(
            m, k, n, spec=spec, dtype_bytes=dtype_bytes, stages=stages
        ), False


# ---------------------------------------------------------------------------
# Hot-path lookup for the execution contexts: env-var gated, mtime-memoized
# ---------------------------------------------------------------------------

# Seconds between two checks of the file's mtime.  Every GEMM call asks for
# the cache, and a stat of the file takes tens of microseconds on the H100
# machines (``chip_smoke.py`` phase 9 times one, and a forward that
# re-checks on every lookup), so the file is re-checked at most this
# often; a save from this process takes effect at once.
STAT_INTERVAL_S = 1.0

# path -> (mtime_ns, monotonic time of the last check, cache)
_memo: dict[str, tuple[int, float, TuningCache]] = {}


def active_cache() -> Optional[TuningCache]:
    """The cache named by ``$REPRO_TORCH_TUNING_CACHE``, or None when unset.

    Reloaded when the file's mtime changes (checked at most every
    ``STAT_INTERVAL_S``) or when this process saves a cache.
    """

    path = os.environ.get(ENV_VAR)
    if not path:
        return None
    now = time.monotonic()
    hit = _memo.get(path)
    if hit is not None and now - hit[1] < STAT_INTERVAL_S:
        return hit[2]
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        _memo.pop(path, None)
        return None
    cache = hit[2] if hit is not None and hit[0] == mtime else TuningCache.load(path)
    _memo[path] = (mtime, now, cache)
    return cache


def cached_block_config(
    m: int,
    k: int,
    n: int,
    dtype_name: str,
    dtype_bytes: int,
    *,
    spec_name: Optional[str] = None,
) -> Optional[BlockConfig]:
    """Kernel-side lookup: tuned config or None (caller derives analytically).

    ``spec_name`` selects the per-class entry (control trees pass their
    class's spec); when omitted, ``$REPRO_TORCH_TUNING_SPEC`` names it
    (default ``h100``).
    """

    cache = active_cache()
    if cache is None:
        return None
    if spec_name is None:
        spec_name = os.environ.get(ENV_SPEC_VAR, H100.name)
    cfg = cache.lookup(spec_name, dtype_name, m, k, n)[0]
    if cfg is not None and cfg.dtype_bytes != dtype_bytes:
        cfg = dataclasses.replace(cfg, dtype_bytes=dtype_bytes)
    return cfg


def cached_kernel_backend(
    m: int,
    k: int,
    n: int,
    dtype_name: str,
    *,
    spec_name: Optional[str] = None,
) -> Optional[str]:
    """The raw ``"backend"`` field of the active cache entry, or None.

    Returns the string as stored; callers validate it against the GEMM
    dispatch entries.
    """

    cache = active_cache()
    if cache is None:
        return None
    if spec_name is None:
        spec_name = os.environ.get(ENV_SPEC_VAR, H100.name)
    return cache.lookup(spec_name, dtype_name, m, k, n)[1]


__all__ = [
    "CACHE_VERSION",
    "DEFAULT_PATH",
    "ENV_VAR",
    "ENV_SPEC_VAR",
    "TuningCache",
    "shape_bucket_key",
    "active_cache",
    "cached_block_config",
    "cached_kernel_backend",
]
