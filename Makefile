# Build + check entry points (the reference ships per-variant Makefiles with a
# `check` target, e.g. MPI/Makefile:21-22; here one Makefile covers the repo).

CXX ?= g++
CXXFLAGS ?= -O3 -std=c++17 -fPIC -Wall -Wextra
NATIVE_DIR := native
NATIVE_BUILD := $(NATIVE_DIR)/build
NATIVE_LIB := $(NATIVE_BUILD)/liblbmio.so
CHECK_DIR ?= check_out

.PHONY: all native test check smoke clean

all: native

native: $(NATIVE_LIB)

$(NATIVE_LIB): $(NATIVE_DIR)/lbmio.cpp
	mkdir -p $(NATIVE_BUILD)
	$(CXX) $(CXXFLAGS) -shared -o $@ $<

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q

# Run the 1024x1024 reference scene end-to-end and validate against its
# golden data at 1% tolerance (the reference's `make check` contract).
check: native
	python -m lbm_tpu run golden/input_1024x1024.params \
	    golden/obstacles_1024x1024.dat --out-dir $(CHECK_DIR)
	python -m lbm_tpu check \
	    --ref-av-vels-file golden/1024x1024.av_vels.dat.gz \
	    --ref-final-state-file golden/1024x1024.final_state.dat.gz \
	    --av-vels-file $(CHECK_DIR)/av_vels.dat \
	    --final-state-file $(CHECK_DIR)/final_state.dat

# The GPU smoke run: main path f32 + i16 against the goldens, step vs
# oracle (one card).  `python chip_smoke.py --devices 4` runs the sharded
# phase on four cards.
smoke:
	python chip_smoke.py

clean:
	rm -rf $(NATIVE_BUILD) $(CHECK_DIR)
