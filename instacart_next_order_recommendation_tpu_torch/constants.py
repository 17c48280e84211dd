"""Paths and filenames shared with the JAX package's on-disk formats.

The port keeps its own copy of the names it needs, so a tower directory, an
embedding cache or a processed dataset written by either package is read by
the other.
"""

from pathlib import Path

# Repository root (parent of the package directory)
PROJECT_ROOT = Path(__file__).resolve().parents[1]

# Config files (YAML)
CONFIG_DIR = PROJECT_ROOT / "configs"
DEFAULT_CONFIG_TRAIN = CONFIG_DIR / "train.yaml"

# Processed data (written by the JAX package's data prep)
DEFAULT_PROCESSED_DIR = PROJECT_ROOT / "processed"
EVAL_QUERIES_FILENAME = "eval_queries.json"
EVAL_CORPUS_FILENAME = "eval_corpus.json"
EVAL_RELEVANT_DOCS_FILENAME = "eval_relevant_docs.json"
DATA_PREP_PARAMS_FILENAME = "data_prep_params.json"
TRAIN_DATASET_SUBDIR = "train_dataset"
EVAL_DATASET_SUBDIR = "eval_dataset"

# Training outputs
DEFAULT_OUTPUT_DIR = PROJECT_ROOT / "models_out" / "two_tower"
FINAL_SUBDIR = "final"

# Embedding index cache (under the corpus's parent directory)
INDEX_SUBDIR = ".embedding_index"
MANIFEST_FILENAME = "manifest.json"
EMBEDDINGS_FILENAME = "embeddings.npy"
PRODUCT_IDS_FILENAME = "product_ids.json"

# Tower checkpoint directory
PARAMS_FILENAME = "params.msgpack"
MODEL_CONFIG_FILENAME = "model_config.json"
