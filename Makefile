.PHONY: test bench demo native clean real-data real-data-check flagship

test:
	python -m pytest tests/ -q

bench:
	python bench.py

# Flagship training run: the validated large-batch recipe (B=512 lr 3e-4,
# 8-epoch cosine horizon, best NDCG@10 0.4133 on the synthetic
# reference-scale workspace — docs/VALIDATION.md "Round 4"). Expects a
# processed dir (see configs/train_large_batch.yaml: processed_dir).
flagship:
	python -m instacart_next_order_recommendation_tpu.train --config configs/train_large_batch.yaml

# Real-dataset parity run: drop the Kaggle CSVs into data/instacart/ and an
# all-MiniLM-L6-v2 checkpoint into models/all-MiniLM-L6-v2/, then run this —
# prep -> warm-started 5-epoch train -> per-epoch table vs BASELINE.md
# (written to REAL_RESULTS.md). See scripts/real_data_run.py.
real-data:
	python scripts/real_data_run.py

real-data-check:
	python scripts/real_data_run.py --check

demo:
	python scripts/run_demo.py --workdir demo_workspace

native:
	$(MAKE) -C native

clean:
	rm -rf demo_workspace nb_workspace .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +

# The PyTorch/CUDA port (instacart_next_order_recommendation_tpu_torch/) on
# an NVIDIA GPU: the same workflows as the targets above. Each runs on the
# card (without one they exit non-zero; the scripts take --device cpu).
.PHONY: bench-cuda flagship-cuda real-data-cuda real-data-check-cuda demo-cuda smoke-cuda

bench-cuda:
	python3 bench_cuda.py

flagship-cuda:
	python -m instacart_next_order_recommendation_tpu_torch.train --config configs/train_large_batch.yaml

real-data-cuda:
	python scripts/torch_real_data_run.py

real-data-check-cuda:
	python scripts/torch_real_data_run.py --check

demo-cuda:
	python scripts/torch_run_demo.py --workdir demo_workspace

smoke-cuda:
	python3 chip_smoke.py
