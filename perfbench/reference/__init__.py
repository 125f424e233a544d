"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch modules (the detector and both heads, the losses, targets,
pseudo-labels, the semi step, the optimizer and EMA, augmentation,
decode + NMS, host preprocessing) at the commit that defined the
benchmark, with the point searches in ``ops`` as plain PyTorch on any
device and the collectives in ``parallel`` as their one-process forms.

It imports nothing of the port, so that a later change to the port is
judged against this copy and cannot move it.
"""
