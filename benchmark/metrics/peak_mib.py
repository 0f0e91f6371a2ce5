"""peak_mib: `torch.cuda.max_memory_allocated` over the run, in MiB."""


def read(run):
    return run.peak_bytes / 2 ** 20
