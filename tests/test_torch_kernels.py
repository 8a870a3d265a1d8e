"""How kernel libraries are named and found, on the CPU (no ``nvcc`` is
needed: nothing here compiles).

A library is named by a hash of what goes into its build, so an edited
source or header is never served from a stale ``.so``; headers
(``csrc/*.cuh``) are shared by the sources and are not sources themselves.
"""

from kube_sqs_autoscaler_tpu_torch.workloads import kernels


def test_library_path_follows_headers_and_sources_list_only_cu(tmp_path,
                                                               monkeypatch):
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    (tmp_path / "attend.cu").write_text('#include "helpers.cuh"\n')
    header = tmp_path / "helpers.cuh"
    header.write_text("// v1\n")
    before = kernels._library_path("attend")
    assert kernels._library_path("attend") == before  # stable

    header.write_text("// v2\n")
    after_header = kernels._library_path("attend")
    assert after_header != before
    assert after_header.name.startswith("libattend-")

    (tmp_path / "attend.cu").write_text('#include "helpers.cuh"\n// edit\n')
    assert kernels._library_path("attend") not in (before, after_header)
    assert kernels.sources() == ["attend"]


def test_library_path_follows_the_flags(monkeypatch):
    before = kernels._library_path("flash_bwd")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels._library_path("flash_bwd") != before
