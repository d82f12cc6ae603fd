#!/usr/bin/env bash
# ASan/UBSan lane for the native C++ host components (reference:
# ci/run_tests.sh:5-18 runs its whole suite under ASan+UBSan+LSan).
set -euo pipefail
cd "$(dirname "$0")/.."
SAN_LIB=build_asan/libalbatross_native_asan.so
mkdir -p build_asan
g++ -O1 -g -std=c++17 -shared -fPIC \
    -fsanitize=address,undefined -fno-omit-frame-pointer \
    albatross_tpu/_native/native.cpp -o "$SAN_LIB"
# exercise every exported entry point under the sanitizer; ASan must be
# preloaded because python itself is uninstrumented
ASAN_LIB=$(g++ -print-file-name=libasan.so)
env PYTHONPATH="$PWD" JAX_PLATFORMS=cpu \
    LD_PRELOAD="$ASAN_LIB" \
    ASAN_OPTIONS=detect_leaks=0:abort_on_error=1 \
    ALBATROSS_NATIVE_LIB="$PWD/$SAN_LIB" \
    python ci/native_exercise.py
echo "native ASan/UBSan lane: ALL OK"
