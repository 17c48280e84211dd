"""Mean host milliseconds of the program's ``serve.launch`` span over the
traced window: ``FusedServePipeline.run_device``'s launches of a batch's
encode, top-k and packing, with no sync."""

from benchmark import program_trace


def read(name, reading):
    return program_trace.mean_ms("serve.launch")
