from repro_torch.data.tokenizer import ByteTokenizer  # noqa: F401
from repro_torch.data.pipeline import LMStream, input_batch_for  # noqa: F401
from repro_torch.data.tasks import ClassificationTask, make_task_suite  # noqa: F401
