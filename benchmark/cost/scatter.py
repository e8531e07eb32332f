"""K1, the resampler-backward scatter, in one training step: the bytes it
has to move (chip_smoke.py's bound): the index of every update read
once, the values of the live updates read once, the table written once.

The table is the window table of the prediction, (bs * uvh * uvw) rows
of 4 x 3 float32 (a texel's 2 x 2 neighbourhood); an update is a camera
pixel, live where its warp is not pinned to the blacked-out texel."""

W = 12   # floats a table row: 4 corners x 3 channels


def step_bytes(cfg, live_per_example):
    bs = cfg["bs"]
    updates = bs * cfg["imh"] * cfg["imw"]
    live = bs * live_per_example
    rows = bs * cfg["uvh"] * cfg["uvw"]
    return 4 * updates + 4 * W * live + 4 * W * rows
