from repro_torch.data.tokenizer import Vocab
from repro_torch.data.tasks import TaskSuite, TaskSuiteConfig

__all__ = ["Vocab", "TaskSuite", "TaskSuiteConfig"]
