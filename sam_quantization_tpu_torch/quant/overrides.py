"""Per-op quantization-config overrides (mixed precision / layer exclusion).

Counterpart of ``sam_quantization_tpu/quant/overrides.py``, a pure-Python
copy: the reference PPQ quantizer's per-op controls
(script/custimized_quant.py:56-147), the mechanism that turns a *diagnosis*
(worst-SNR ops from ``analysis.layerwise_error_analyse``) into an *action*
(keep those ops at 8 bits, or dense, while the rest go to 4 bits).

Rules are ordered ``(fnmatch pattern, OpOverride)`` pairs matched against a
layer's path (e.g. ``blocks.7.mlp.lin2``); every matching rule merges, the
later ones taking precedence, so broad rules go first and surgical
exceptions after. ``quant.sequential`` reads ``bits`` / ``groupsize`` /
``sym`` in place of the global ``GPTQConfig``'s and leaves a ``skip`` layer
dense. FQ-ViT (``quant.fq.pipeline.FQCtx``) matches the rules against its
observation points' paths (``blocks.1.qact2``): ``observer`` replaces the
activation observer there, ``bits`` its bit type, and ``skip`` leaves the
point float.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class OpOverride:
    """Per-op knobs; ``None`` = inherit the global config."""

    bits: Optional[int] = None
    groupsize: Optional[int] = None
    sym: Optional[bool] = None
    skip: bool = False  # leave this op unquantized (FP)
    observer: Optional[str] = None  # FQ activation observer name

    def merged_into(self, other: "OpOverride") -> "OpOverride":
        """Later rule fields override earlier ones (None = keep)."""
        return OpOverride(
            bits=self.bits if self.bits is not None else other.bits,
            groupsize=(
                self.groupsize if self.groupsize is not None else other.groupsize
            ),
            sym=self.sym if self.sym is not None else other.sym,
            skip=self.skip or other.skip,
            observer=self.observer if self.observer is not None else other.observer,
        )


class QuantOverrides:
    """Ordered pattern → :class:`OpOverride` rules; all matches merge, later
    rules taking precedence (PPQ dispatching-table semantics)."""

    def __init__(self, rules: Sequence[Tuple[str, OpOverride]] = ()):
        self.rules: List[Tuple[str, OpOverride]] = list(rules)

    def add(self, pattern: str, **kwargs) -> "QuantOverrides":
        self.rules.append((pattern, OpOverride(**kwargs)))
        return self

    def match(self, path: str) -> Optional[OpOverride]:
        hit: Optional[OpOverride] = None
        for pattern, ov in self.rules:
            if fnmatch.fnmatchcase(path, pattern):
                hit = ov if hit is None else ov.merged_into(hit)
        return hit

    def __bool__(self) -> bool:
        return bool(self.rules)

    # -- (de)serialization: ship with quantized artifacts -------------------

    def to_json(self) -> str:
        return json.dumps(
            [
                {"pattern": p, **{k: v for k, v in dataclasses.asdict(ov).items()
                                  if v not in (None, False)}}
                for p, ov in self.rules
            ]
        )

    @classmethod
    def from_json(cls, s: str) -> "QuantOverrides":
        rules = []
        for item in json.loads(s):
            pattern = item.pop("pattern")
            rules.append((pattern, OpOverride(**item)))
        return cls(rules)

    # -- diagnosis → action --------------------------------------------------

    @classmethod
    def bump_worst_snr(
        cls,
        snrs: Dict[str, float],
        k: int,
        bits: int = 8,
        skip: bool = False,
        min_snr_db: Optional[float] = None,
    ) -> "QuantOverrides":
        """Build overrides raising the ``k`` worst-SNR ops (from
        ``analysis.graphwise_error_analyse`` / ``layerwise_error_analyse``)
        to ``bits`` (or excluding them entirely with ``skip=True``) — the
        diagnose→selectively-quantize flow of the reference's PPQ scripts
        (script/analysis.py:596-625 feeding custimized_quant.py decisions).
        """
        items = sorted(snrs.items(), key=lambda kv: kv[1])
        if min_snr_db is not None:
            items = [it for it in items if it[1] < min_snr_db]
        rules = [
            (path, OpOverride(bits=None if skip else bits, skip=skip))
            for path, _ in items[:k]
        ]
        return cls(rules)
