"""Data layer: the `.pth` corpus schema, dense corpora, synthetic data and
splits (numpy on the host; the trainer moves whole corpora to the device)."""

from cerebra_torch.data.schema import (  # noqa: F401
    LabelCatalog,
    RawCorpus,
    load_corpus_pth,
    load_split_indices,
)
from cerebra_torch.data.corpus import EEGCorpus  # noqa: F401
from cerebra_torch.data.synthetic import make_synthetic_corpus  # noqa: F401
from cerebra_torch.data.sampling import epoch_batches, random_split_indices  # noqa: F401
