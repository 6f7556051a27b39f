"""Host-side data pipeline of the port (numpy): datasets, loader,
tokenizer, synthetic data and train / eval batching."""

from .batching import (batchify_eval, batchify_train, bucket_length, bucket_pow2,
                       bucket_queries, min_chunk_size, pad_axis,
                       pe_interp_arrays, reference_padded_len)
from .dataset import (DATASETS, BaseDataset, VideoCentricCLIPDataset,
                      VideoCentricCLIPTwoFeatDataset, VideoCentricDataset,
                      VideoCentricTwoFeatDataset, make_dataset)
from .loader import DataLoader
from .synthetic import apply_synthetic_cfg, make_synthetic_dataset
from .tokenizer import GloVeTokenizer, basic_english_tokenize, make_tokenizer
