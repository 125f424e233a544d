"""The work a call needs, as functions of the configuration and the
call's shapes, and the chip's published peaks: the yardstick of the
roofline and ``mfu`` metrics. Never read from what the program
dispatched, so a later change that fuses or replaces a kernel is measured
against the same work."""
