"""Host utilities of the port: ``video``, ``tracing`` (the program's spans,
counters and request records, and ``torch.profiler`` traces), and copies of the JAX package's host modules
``jobs``, ``progress``, ``statedict`` and ``workerpool``."""

from ganspace_tpu_torch.utils.jobs import (
    claim_job, exit_if_job_done, job_done, mark_job_done, pending_jobs,
    release_job,
)
from ganspace_tpu_torch.utils.progress import (
    default_progress, desc_progress, post_progress, print_progress,
    verbose_progress,
)
from ganspace_tpu_torch.utils.statedict import (
    flatten_tree, load_state_dict, numpy_state_dict, save_state_dict,
    unflatten_tree,
)
from ganspace_tpu_torch.utils.workerpool import WorkerBase, WorkerPool

__all__ = [
    "claim_job", "exit_if_job_done", "job_done", "mark_job_done",
    "pending_jobs", "release_job",
    "default_progress", "desc_progress", "post_progress", "print_progress",
    "verbose_progress", "WorkerBase", "WorkerPool",
    "flatten_tree", "unflatten_tree", "save_state_dict",
    "load_state_dict", "numpy_state_dict",
]
