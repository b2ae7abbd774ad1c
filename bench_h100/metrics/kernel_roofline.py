"""kernel_roofline (kernels): the least time the card needs for the window's
real blind rotations (harness/roofline.py) over the device time of the
blind-rotation kernels, in %.  Nothing to read where no such kernel ran."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    rot = sum(tr.rotation_s(d) for d in tr.devices())
    if rot <= 0:
        return None
    return 100.0 * run.least_rotation_s * len(run.times) / rot
