# Developer tooling (the analog of the reference's tasks.py invoke targets,
# reference: tasks.py:5-93 config/build/run/clean).

.PHONY: test test-fast native bench smoke render serve clean

test:
	python -m pytest tests/ -q

# fast tier: everything not marked `slow` (heavy e2e runs) — oracle
# goldens, the closest-hit kernel through the Pallas interpreter, scene
# CRUD, camera, viewer endpoints.
test-fast:
	python -m pytest tests/ -q -m "not slow"

native:
	python -m cudaraytracer_tpu.native.build

bench:
	python bench.py

smoke:
	python chip_smoke.py

render:
	python -m cudaraytracer_tpu render --scene rtow_final --camera-model look_at \
	    --width 640 --height 360 -o render.png

serve:
	python -m cudaraytracer_tpu serve --scene default --width 640 --height 360

clean:
	rm -rf cudaraytracer_tpu/native/libcrt_native.so render.png smoke_out
	find . -name __pycache__ -type d -exec rm -rf {} +
