"""Paths, filenames and environment variable names shared with the JAX
package.

The port keeps its own copy of the names it needs, so a tower directory, an
embedding cache or a processed dataset written by either package is read by
the other.
"""

from pathlib import Path

# Repository root (parent of the package directory)
PROJECT_ROOT = Path(__file__).resolve().parents[1]

# HTTP API environment (the JAX package's names): the feedback DB, the
# model and corpus the server loads, the API key, the per-client rate limit
# ("100/minute") and the largest corpus POST /admin/corpus takes.
ENV_FEEDBACK_DB_PATH = "FEEDBACK_DB_PATH"
ENV_MODEL_DIR = "MODEL_DIR"
ENV_CORPUS_PATH = "CORPUS_PATH"
ENV_API_KEY = "API_KEY"
ENV_RATE_LIMIT = "RATE_LIMIT"
ENV_MAX_CORPUS_UPLOAD_PRODUCTS = "MAX_CORPUS_UPLOAD_PRODUCTS"
# HTTP server bounds: concurrently handled connections (the excess gets a
# fast 503), per-connection socket timeout in seconds (a slow client cannot
# pin a worker), and the largest request body in bytes (a larger one gets
# 413 before it is read).
ENV_HTTP_MAX_CONCURRENCY = "HTTP_MAX_CONCURRENCY"
ENV_HTTP_SOCKET_TIMEOUT = "HTTP_SOCKET_TIMEOUT"
ENV_HTTP_MAX_BODY_BYTES = "HTTP_MAX_BODY_BYTES"
DEFAULT_HTTP_MAX_CONCURRENCY = 64
DEFAULT_HTTP_SOCKET_TIMEOUT = 30.0
DEFAULT_HTTP_MAX_BODY_BYTES = 64 * 1024 * 1024  # corpus uploads are tens of MB

# Config files (YAML)
CONFIG_DIR = PROJECT_ROOT / "configs"
DEFAULT_CONFIG_TRAIN = CONFIG_DIR / "train.yaml"
DEFAULT_CONFIG_INFERENCE = CONFIG_DIR / "inference.yaml"
DEFAULT_CONFIG_BASELINES = CONFIG_DIR / "baselines.yaml"
DEFAULT_CONFIG_DATA_PREP = CONFIG_DIR / "data_prep.yaml"
DEFAULT_CONFIG_COMPARE = CONFIG_DIR / "compare_untrained_vs_trained.yaml"
DEFAULT_CONFIG_FEEDBACK_ANALYTICS = CONFIG_DIR / "feedback_analytics.yaml"
DEFAULT_CONFIG_GENERATE_SAMPLE_FEEDBACK = CONFIG_DIR / "generate_sample_feedback.yaml"

# Raw Instacart CSVs (the Kaggle layout) under data_dir, read by the data
# prep and the item-item CF baseline; order_products__prior.csv (~32M rows)
# is streamed in chunks of ORDER_PRODUCTS_CHUNK_SIZE rows.
DEFAULT_DATA_DIR = PROJECT_ROOT / "data"
PRODUCTS_CSV = "products.csv"
AISLES_CSV = "aisles.csv"
DEPARTMENTS_CSV = "departments.csv"
ORDERS_CSV = "orders.csv"
ORDER_PRODUCTS_PRIOR_CSV = "order_products__prior.csv"
ORDER_PRODUCTS_TRAIN_CSV = "order_products__train.csv"
ORDER_PRODUCTS_CHUNK_SIZE = 500_000

# orders.csv eval_set column values
EVAL_SET_TRAIN = "train"
EVAL_SET_PRIOR = "prior"

# Processed data (written by the data prep, ``data/prepare.py``)
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

# Serving defaults
DEFAULT_MODEL_DIR = DEFAULT_OUTPUT_DIR / FINAL_SUBDIR
DEFAULT_CORPUS_PATH = DEFAULT_PROCESSED_DIR / "p5_mp20_ef0.1" / EVAL_CORPUS_FILENAME

# Corpus upload limit for POST /admin/corpus
MAX_CORPUS_UPLOAD_PRODUCTS = 100_000

# Feedback store
DEFAULT_FEEDBACK_DB_PATH = PROJECT_ROOT / "data" / "feedback.db"

# Sample user contexts (the demo and the sample-feedback load generator)
SAMPLE_USER_CONTEXTS = [
    "[+7d w4h14] Organic Milk, Whole Wheat Bread.",
    "[+3d w1h9] Banana, Greek Yogurt, Honey.",
    "[+14d w6h18] Chicken Breast, Broccoli, Rice.",
    "[+1d w0h12] Coffee, Oat Milk, Granola.",
    "[+5d w3h20] Pasta, Tomato Sauce, Parmesan.",
]

# Demo query used by the serve CLI when no query is configured
DEMO_QUERY = "[+7d w4h14] Organic Milk, Whole Wheat Bread."

# Hugging Face fallback for a corpus missing on disk (used only where the
# local file is absent and the hub is reachable)
ENV_CORPUS_HF_REPO = "CORPUS_HF_REPO"
ENV_CORPUS_HF_REPO_TYPE = "CORPUS_HF_REPO_TYPE"
DEFAULT_CORPUS_HF_REPO = "chenbowen184/product-artifacts"
DEFAULT_CORPUS_HF_REPO_TYPE = "dataset"
DEFAULT_CORPUS_HF_FILENAME = "product_catalog_corpus_p5_mp20_ef0.1.json"
DEFAULT_QUERIES_HF_FILENAME = "product_queries_p5_mp20_ef0.1.json"

# Serving environment: the device the serve CLI runs on ("cuda" or "cpu"),
# and the micro-batching window in milliseconds (0/unset = off).
ENV_INFERENCE_DEVICE = "INFERENCE_DEVICE"
ENV_BATCH_WINDOW_MS = "BATCH_WINDOW_MS"

# Embedding index cache (under the corpus's parent directory)
INDEX_SUBDIR = ".embedding_index"
MANIFEST_FILENAME = "manifest.json"
EMBEDDINGS_FILENAME = "embeddings.npy"
PRODUCT_IDS_FILENAME = "product_ids.json"

# Tower checkpoint directory
PARAMS_FILENAME = "params.msgpack"
MODEL_CONFIG_FILENAME = "model_config.json"

# Top-k extraction: "exact" (default) or "packed" (the 20-bit packed
# score + index kernel; scores quantized to about 3 decimal digits).
# Read by Recommender when it is not given one.
ENV_TOPK_EXTRACTION = "ITOR_TOPK_EXTRACTION"
