"""The calls per image that block the host on the card: the sum of the
``arg`` of the window's ``wait.*`` spans (each span's count of blocking
calls) over the images the window finished. In the offline cells an image
makes two scalar copies a regeneration launch, seven a frame of the
frame-by-frame tail (its blend's scalar and six in host raygen) and one
copy of the framebuffer to the host. None where the program keeps no
``wait.*`` span, and without device spans (a run on the CPU, where no
call blocks on a card)."""

from benchmark.metrics import waits


def read(view):
    if not view.device_spans:
        return None
    got = waits.waits(view)
    images = len(view.driver.images)
    if got is None or not images:
        return None
    return sum(r.arg or 0 for r in got) / images
