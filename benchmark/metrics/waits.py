"""The program's ``wait.*`` spans (``spectral_tpu_torch.runtime.trace``)
on the traced window's clock, for the readers of the host's waits on the
card.

The rows reach the profiler's clock through ``program.rows``: one shift,
taken where the window starts. On an H100 that puts a wait's end from 24
us before to 45 us after the kernel it waited for, at both ends of an 8 s
window (the host's return from the synchronisation takes up to 30 us of
it), so the two clocks agree within a few ppm there. ``trace.clock_map``
through both ends of the window's span put the far end 0.26-0.55 ms late:
the trace times the
end of the window's span that much after the program clock's reading of
it (``tests/test_torch_cuda.py``'s clock test). None where the program keeps
no ``wait.*`` span in the window, as a program older than them.
"""

from __future__ import annotations

from benchmark.metrics import program

# the device spans of the bounce kernels, by a part of their names
BOUNCE_KERNELS = ("regen_kernel", "mono_kernel", "persist_kernel", "cost_kernel", "seg_kernel")


def spans(view):
    """The program's spans inside the window on the profiler's clock, if
    any of them is a ``wait.*`` span; else None."""
    got = program.rows(view)
    if got is None or not any(r.name.startswith("wait.") for r in got[0]):
        return None
    return got[0]


def waits(view):
    """The window's ``wait.*`` spans; None where there are none."""
    got = spans(view)
    return None if got is None else [r for r in got if r.name.startswith("wait.")]
