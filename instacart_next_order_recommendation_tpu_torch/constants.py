"""Filenames shared with the JAX package's on-disk formats.

The port keeps its own copy of the names its serve path needs, so a tower
directory or an embedding cache written by either package is read by the
other.
"""

# Embedding index cache (under the corpus's parent directory)
INDEX_SUBDIR = ".embedding_index"
MANIFEST_FILENAME = "manifest.json"
EMBEDDINGS_FILENAME = "embeddings.npy"
PRODUCT_IDS_FILENAME = "product_ids.json"

# Tower checkpoint directory
PARAMS_FILENAME = "params.msgpack"
MODEL_CONFIG_FILENAME = "model_config.json"
