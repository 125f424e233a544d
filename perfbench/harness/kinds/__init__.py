"""One module per kind of traffic (``"kind"`` in a traffic file): the
set-up, the unit of work the window repeats, the end-to-end metrics of a
window and the comparison with the reference."""
