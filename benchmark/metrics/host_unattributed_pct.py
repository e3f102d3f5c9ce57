"""Share of the time in root spans that the entry, serving and group
spans spend in their own code (self time of entry.*, serve.*,
batch.group), outside every stage span: what the stage spans leave
unnamed."""
from benchmark.program_spans import recorded, self_ns

OWN = ("entry.batch", "entry.single", "serve.submit", "serve.finish",
       "batch.group")


def read(run):
    t = recorded(run)
    return None if t is None else 100.0 * self_ns(t, OWN) / t["root_ns"]
