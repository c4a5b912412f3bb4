"""Tombstone for the legacy per-GPU process launcher (reference:
``apex/parallel/multiproc.py :: main`` — forks one ``python main.py``
per device with ``--world-size``/``--rank`` argv appended).

Port of ``apex_tpu/parallel/multiproc.py``, a tombstone there too: the
reference itself deprecates this launcher in favour of
``torch.distributed.launch``.  Importing this module raises with the
way to start one process a card instead, so a stale ``python -m
apex.parallel.multiproc train.py`` recipe fails loudly rather than
running one unsharded process.
"""

raise ImportError(
    "apex_tpu_torch.parallel.multiproc does not exist: the reference's "
    "per-GPU fork launcher is deprecated. Start one process a card with "
    "`torchrun --nproc_per_node=<cards> train.py` (each process reads "
    "RANK, LOCAL_RANK and WORLD_SIZE, calls torch.cuda.set_device("
    "LOCAL_RANK) and torch.distributed.init_process_group('nccl')), or "
    "spawn them with torch.multiprocessing.start_processes(..., "
    "start_method='spawn'), one process a card.")
