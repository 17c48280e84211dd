"""Mean host milliseconds of the program's ``serve.upload`` span over the
traced window: ``FusedServePipeline.topk_device``'s cast of a batch's ids
and their copy from pageable host memory to the device."""

from benchmark import program_trace


def read(name, reading):
    return program_trace.mean_ms("serve.upload")
