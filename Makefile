# Developer entry points.

.PHONY: all oracle test bench clean

all: oracle

# native scalar oracle (also built on demand by the ctypes loader)
oracle:
	cmake -S sangnom_jax/oracle -B build/oracle $(shell command -v ninja >/dev/null && echo -G Ninja)
	cmake --build build/oracle

test:
	python -m pytest tests/ -q

bench:
	python bench.py

clean:
	rm -rf build sangnom_jax/oracle/_build .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
