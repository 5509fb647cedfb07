"""index_bytes (bytes/row): device memory the program holds after its
build and warm-up, less what it held before the build
(``torch.cuda.memory_allocated``), a row of the dataset."""


def read(run):
    return run.index_bytes if run.index_bytes > 0 else None
