"""Host ms per traced step in the program's spans inside
`train_step_shared` that wait on the device's queue: its reads (kind
'read': each update's `clip_read` and `metrics_read`) and its uploads
from pageable memory (kind 'upload': D's resize matrices, VGG's mean and
std, the hash fold's corner bits), from rank 0's recorder
(`portbench/spans.py`)."""
from portbench import spans


def read(ctx):
    return spans.read_ms_per_unit(spans.taken(ctx), 'step', 'train.step')
