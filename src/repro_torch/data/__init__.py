from repro_torch.data.synthetic import (
    SyntheticClassification, SyntheticTokens, SyntheticSpeech, make_task_dataset,
)
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.pipeline import (DataLoader, StackedLoader,
                                       sharded_batches)

__all__ = [
    "SyntheticClassification", "SyntheticTokens", "SyntheticSpeech",
    "make_task_dataset", "dirichlet_partition", "iid_partition",
    "DataLoader", "StackedLoader", "sharded_batches",
]
