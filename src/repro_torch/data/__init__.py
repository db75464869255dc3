"""Data of the RL loop and of the simulator: toy tasks with programmatic
rewards (``tasks``) and the heavy-tailed rollout workloads of the paper's
traces (``workload``, a numpy copy of ``repro.data.workload``)."""
from repro_torch.data.workload import (KIMI_K2, MOONLIGHT, QWEN2_VL_72B,
                                       WORKLOADS, Workload, WorkloadSpec,
                                       group_token_streams, length_stats,
                                       make_workload, sample_lengths)
from repro_torch.data.tasks import RewardWorker, Task, Tokenizer, make_task

__all__ = [
    "KIMI_K2", "MOONLIGHT", "QWEN2_VL_72B", "WORKLOADS", "Workload",
    "WorkloadSpec", "group_token_streams", "length_stats", "make_workload",
    "sample_lengths", "RewardWorker", "Task", "Tokenizer", "make_task",
]
