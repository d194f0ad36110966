"""The port's CUDA build (``repro_torch.kernels.build``) without a compiler:
a library is named by everything that goes into it, so an edited source or
header never loads a stale library from ``build/``."""
from repro_torch.kernels import build


def test_library_path_tracks_the_source_and_its_headers(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "k.cuh"\nextern "C" int f() { return K; }\n')
    header = tmp_path / "k.cuh"
    header.write_text("#define K 1\n")
    first = build.library_path(src)
    assert first.parent == build.BUILD_DIR and first.suffix == ".so"
    assert first.name.startswith("k-")
    assert build.library_path(src) == first  # the same inputs, the same name

    header.write_text("#define K 2\n")
    second = build.library_path(src)
    assert second != first
    (tmp_path / "more.h").write_text("// a new header beside it\n")
    third = build.library_path(src)
    assert third not in (first, second)
    (tmp_path / "notes.txt").write_text("not a header\n")
    assert build.library_path(src) == third
    src.write_text(src.read_text() + "// edited\n")
    assert build.library_path(src) not in (first, second, third)


def test_build_keeps_ptxas_report_flags():
    """chip_smoke.py prints the registers, shared memory and spills that
    ``-Xptxas -v`` reports, from the log the build keeps."""
    flags = " ".join(build.NVCC_FLAGS)
    assert "-Xptxas -v" in flags and "arch=compute_90a,code=sm_90a" in flags
