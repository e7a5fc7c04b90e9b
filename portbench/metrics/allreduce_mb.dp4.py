"""MB rank 0 all-reduces per traced step: the program's counter
`allreduce_bytes` (each `mesh.all_mean_`'s flat float32 buffer) over the
traced steps, / 1e6 (`portbench/spans.py`)."""
from portbench import spans


def read(ctx):
    v = spans.counter_per_unit(spans.taken(ctx), 'allreduce_bytes', 'step')
    return None if v is None else v / 1e6
