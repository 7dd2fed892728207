"""Percent of the traced window in which the card is idle while the host
is inside an outermost span of the program other than ``gc``
(``program.idle_in_program_pct``); ``device.idle_pct.render`` less this is
the idle time outside the program. The small-object regeneration cells."""

from benchmark.metrics import program


def read(view):
    return program.idle_in_program_pct(view)
