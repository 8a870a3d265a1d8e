"""How kernel libraries are named, found and read, on the CPU (no
``nvcc`` is needed: nothing here compiles).

A library is named by a hash of what goes into its build, so an edited
source or header is never served from a stale ``.so``; headers
(``csrc/*.cuh``) are shared by the sources and are not sources themselves.
``chip_smoke.py`` reads the machine code of both libraries by their
kernels' mangled names.
"""

import pytest

import chip_smoke
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


# names as cuobjdump -sass prints them after "Function :"
FWD = ("_ZN12_GLOBAL__N_116flash_fwd_kernelI{}Li{}EEEvPKT_S4_S4_PS2_PfN5"
       "flash7StridesES8_S8_NS7_7ProblemE")
BWD = "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelI{}Li{}EEEvPKT_S4_S4_S4_PKfS6_"


@pytest.mark.parametrize("mangled,want", [
    (FWD.format("13__nv_bfloat16", 64), ("flash_fwd", "bf16", 64)),
    (FWD.format("13__nv_bfloat16", 128), ("flash_fwd", "bf16", 128)),
    (FWD.format("f", 64), ("flash_fwd", "f32", 64)),
    (FWD.format("f", 128), ("flash_fwd", "f32", 128)),
    (BWD.format("13__nv_bfloat16", 64), ("flash_bwd_dq", "bf16", 64)),
    ("_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelIfLi128EEEvPKT_",
     ("flash_bwd_dkv", "f32", 128)),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4EEEvi", None),
])
def test_sass_instantiation_reads_forward_and_backward_names(mangled, want):
    assert chip_smoke.sass_instantiation(" " + mangled) == want


def test_sass_counts_tensor_core_instructions_per_instantiation():
    text = "\n".join([
        "\t\tFunction : " + FWD.format("13__nv_bfloat16", 64),
        "        /*0100*/   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "        /*0110*/   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;",
        "        /*0120*/   LDSM.16.M88.4 R8, [R2] ;",
        "\t\tFunction : " + FWD.format("f", 64),
        "        /*0100*/   FFMA R4, R8, R12, R4 ;",
        "\t\tFunction : _ZN2at6native6kernelEv",
        "        /*0100*/   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
    ])
    assert chip_smoke.sass_counts(text) == {("flash_fwd", "bf16", 64): 2,
                                            ("flash_fwd", "f32", 64): 0}
