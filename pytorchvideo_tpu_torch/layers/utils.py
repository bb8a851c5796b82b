"""Width/depth rounding utilities.

Counterpart of pytorchvideo_tpu/layers/utils.py (reference semantics:
pytorchvideo/layers/utils.py:7-49, `set_attributes`, `round_width`,
`round_repeats`).
"""

import math


def round_width(width, multiplier, min_width=8, divisor=8, ceil=False):
    """Round ``width * multiplier`` to a divisor-friendly channel count.

    The result is a multiple of ``divisor``, at least ``min_width``, and
    bumped by ``divisor`` if it fell below 90% of the unrounded target.
    """
    if not multiplier:
        return width

    width *= multiplier
    min_width = min_width or divisor
    if ceil:
        width_out = max(min_width, int(math.ceil(width / divisor)) * divisor)
    else:
        width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def round_repeats(repeats, multiplier):
    """Round the number of block repeats up."""
    if not multiplier:
        return repeats
    return int(math.ceil(multiplier * repeats))


def set_attributes(self, params=None) -> None:
    """Set the attributes of ``self`` from a ``locals()`` dict, its "self"
    left out (upstream layers/utils.py:7-16)."""
    if params:
        for k, v in params.items():
            if k != "self":
                setattr(self, k, v)
