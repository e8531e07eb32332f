"""Channel-schedule generation for the symmetric UV U-Net.

``gen_feat_n`` reproduces the reference's channel ramp semantics
(reference: nlt/util/net.py:18-56): powers of two from ``min_n`` up to
``max_n``, mirrored back down, then decaying by halving to ``final_n``.
E.g. ``gen_feat_n(8, 64) == [8, 16, 32, 64, 64, 32, 16, 8, 4, 3]``.
"""

import math


def gen_feat_n(min_n, max_n, final_n=3):
    assert max_n >= min_n and max_n >= final_n, (
        "Max number of channels must be >= min and >= final channel count")

    # Powers of two strictly between min_n (exclusive) and max_n (inclusive).
    n_ch = [2 ** i for i in range(
        int(math.log2(min_n)) + 1, int(math.log2(max_n)) + 1)]

    if not n_ch or n_ch[0] != min_n:
        n_ch = [min_n] + n_ch
    if n_ch[-1] != max_n:
        n_ch.append(max_n)

    # Mirror: ramp down the way we came up.
    n_ch += n_ch[::-1]

    # Decay by halving from the last value down toward final_n (exclusive).
    n_ch += [2 ** i for i in range(
        int(math.log2(n_ch[-1])) - 1, int(math.log2(final_n)), -1)]

    # Drop any trailing value that undershot final_n.
    while n_ch and n_ch[-1] < final_n:
        n_ch.pop()

    n_ch.append(final_n)
    return n_ch
