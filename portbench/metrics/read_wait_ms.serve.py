"""Host ms per traced frame in the program's spans inside `frame_async`
that wait on the device's queue: its reads (kind 'read': the hit-count
`.tolist()` of the split route, `render.hit_counts`) and its uploads from
pageable memory (kind 'upload': the camera vectors, whose first copy
waits for the previous frame's work and takes most of the reading),
from the program's recorder (`portbench/spans.py`)."""
from portbench import spans


def read(ctx):
    return spans.read_ms_per_unit(spans.taken(ctx), 'frame', 'render.frame')
