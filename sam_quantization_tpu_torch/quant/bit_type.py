"""Integer bit-type descriptors.

The port's own copy of ``sam_quantization_tpu/quant/bit_type.py`` (after
fq_vit/models/ptq/bit_type.py:7-47): the names, bounds and the table
``BIT_TYPE_DICT`` are the JAX package's, so configurations carry across.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BitType:
    bits: int
    signed: bool
    name: str = ""

    def __post_init__(self):
        if not self.name:
            object.__setattr__(
                self, "name", f"{'int' if self.signed else 'uint'}{self.bits}"
            )

    @property
    def upper_bound(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.signed else 2**self.bits - 1

    @property
    def lower_bound(self) -> int:
        return -(2 ** (self.bits - 1)) if self.signed else 0

    @property
    def range(self) -> int:
        return 2**self.bits


BIT_TYPE_DICT = {
    t.name: t
    for t in [
        BitType(2, False),
        BitType(3, False),
        BitType(4, False),
        BitType(4, True),
        BitType(8, True),
        BitType(8, False),
        BitType(16, True),
    ]
}
