"""The run's first job, after imports, the kernel and loader builds and
the CUDA context: what a CLI user pays for one read set beyond the
process start (allocator growth, first CUB workspaces, library loads).
It runs as a user runs it, without ``--profile-stages``, in the traced
run too.  Host clock; it moves ``setup_s``, which holds it."""


def read(run):
    return run.cold_s
