"""Data of the RL loop: toy tasks with programmatic rewards.  The JAX
package's ``repro.data.workload`` (the simulator's traffic) is not
ported yet."""
from repro_torch.data.tasks import RewardWorker, Task, Tokenizer, make_task

__all__ = ["RewardWorker", "Task", "Tokenizer", "make_task"]
