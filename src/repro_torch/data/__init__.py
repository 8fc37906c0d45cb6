from repro_torch.data.datasets import (  # noqa: F401
    ArrayDataset,
    batch_iterator,
    sample_batch,
    synthetic_image_dataset,
    synthetic_token_dataset,
    train_test_split,
)
from repro_torch.data.partition import (  # noqa: F401
    apply_imbalance,
    dirichlet_partition,
    global_distribution,
    label_distributions,
    sort_and_partition,
)
