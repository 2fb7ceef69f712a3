"""The C entry points of csrc/*.cu against the ctypes signatures their
wrappers declare. ctypes converts each argument by the declared type, so a
pointer declared as an int would be cut to 32 bits on the card: every
pointer and the stream must be ``c_void_p``, every int ``c_int``, and the
counts must agree. Needs no GPU and no nvcc."""
import ctypes
import re
from pathlib import Path

import pytest

from apollo_vision_net_tpu_torch.ops import dcn_cuda, msda_cuda

CSRC = Path(__file__).resolve().parent.parent / "apollo_vision_net_tpu_torch" / "csrc"
WRAPPERS = {"msda_fwd.cu": msda_cuda, "msda_bwd.cu": msda_cuda,
            "dcn_fwd.cu": dcn_cuda}
ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def c_entries(source):
    """{name: [param, ...]} of the extern "C" functions of one source."""
    text = (CSRC / source).read_text()
    return {name: [" ".join(p.split()) for p in params.split(",")]
            for name, params in ENTRY.findall(text)}


def test_every_entry_point_has_a_wrapper_signature():
    for module in set(WRAPPERS.values()):
        sources = [s for s, m in WRAPPERS.items() if m is module]
        entries = set().union(*(c_entries(s) for s in sources))
        assert entries == set(module.ARGTYPES), sources
    assert {p.name for p in CSRC.glob("*.cu")} == set(WRAPPERS)
    # the MSDA wrapper loads each entry from its own source
    for name, source in msda_cuda.ENTRY_SOURCE.items():
        assert name in c_entries(source), (name, source)


@pytest.mark.parametrize("source,name", [
    ("msda_fwd.cu", "msda_fwd"),
    ("msda_fwd.cu", "msda_fwd_factored"),
    ("msda_bwd.cu", "msda_bwd"),
    ("msda_bwd.cu", "msda_bwd_factored"),
    ("dcn_fwd.cu", "dcn_fwd"),
    ("dcn_fwd.cu", "dcn_bwd_im2col"),
    ("dcn_fwd.cu", "dcn_bwd_col2im"),
])
def test_wrapper_argtypes_match_the_c_parameters(source, name):
    params = c_entries(source)[name]
    argtypes = WRAPPERS[source].ARGTYPES[name]
    assert len(argtypes) == len(params), (params, argtypes)
    for param, argtype in zip(params, argtypes):
        if "*" in param:
            assert argtype is ctypes.c_void_p, param
        else:
            assert re.fullmatch(r"int \w+", param), param
            assert argtype is ctypes.c_int, param


def test_chip_smoke_reads_stack_frames_and_spills_from_ptxas():
    """chip_smoke's build phase fails when any instance of a vector kernel
    (the plain/masked and factored MSDA forwards, the plain/masked MSDA
    backward's vector and gather kernels, the factored MSDA backward's
    privatizing kernel, the DCN backward's quad d-input kernel) has a
    stack frame or spills, or is missing from the report; it reads them per
    kernel from the report, anonymous-namespace kernels included."""
    import chip_smoke

    report = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_Z24msda_factored_vec_kernelI13__nv_bfloat16Li4EEvPKT_' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z24msda_factored_vec_kernelI13__nv_bfloat16Li4EEvPKT_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 79 registers, used 1 barriers, 224 bytes smem",
        "ptxas info    : Function properties for "
        "_Z15msda_vec_kernelIfLi8EEvPKT_PKfS4_PKiPS0_iiiiiiii10MsdaLevels",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers, 224 bytes smem",
        "ptxas info    : Function properties for "
        "_Z29msda_bwd_factored_priv_kernelI13__nv_bfloat16Li8EEvPKT_PKfS5_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers, used 1 barriers, 224 bytes smem",
        "ptxas info    : Function properties for "
        "_Z19msda_bwd_vec_kernelI13__nv_bfloat16Li8ELb1EEvPKT_PKfS5_PKiS3_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 224 bytes smem",
        "ptxas info    : Function properties for "
        "_Z22msda_bwd_gather_kernelIfLi8EEvPKT_PKiPK4int2PS0_ii",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 24 registers, used 0 barriers",
        "ptxas info    : Function properties for "
        "_ZN43_GLOBAL__N__b68f9870_10_dcn_fwd_cu_b4b4a25017dcn_dinput_kernel"
        "IfEEvPKT_PKfS5_S3_PfS6_S6_iiiiiii",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 123 registers, used 0 barriers",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_114dcn_fwd_kernelIfLi64ELi256ELb1EEEvPKT_",
        "    8 bytes stack frame, 32 bytes spill stores, 32 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
    ])
    fac, vec, priv, bvec, gather, quad, dcn = chip_smoke.ptxas_kernels(report)
    assert (fac["kernel"], fac["registers"], fac["smem_bytes"],
            fac["stack_bytes"], fac["spill_stores"]) == (
        "msda_factored_vec_kernel", 79, 224, 0, 0)
    assert (vec["kernel"], vec["registers"], vec["stack_bytes"],
            vec["spill_loads"]) == ("msda_vec_kernel", 56, 0, 0)
    assert (priv["kernel"], priv["registers"], priv["stack_bytes"]) == (
        "msda_bwd_factored_priv_kernel", 90, 0)
    assert (bvec["kernel"], bvec["registers"], bvec["stack_bytes"]) == (
        "msda_bwd_vec_kernel", 72, 0)
    assert (gather["kernel"], gather["registers"], gather["spill_stores"]) == (
        "msda_bwd_gather_kernel", 24, 0)
    assert (quad["kernel"], quad["registers"], quad["spill_loads"]) == (
        "dcn_dinput_kernel", 123, 0)
    assert (dcn["kernel"], dcn["stack_bytes"], dcn["spill_loads"]) == (
        "dcn_fwd_kernel", 8, 32)
    clean = [fac, vec, priv, bvec, gather, quad]
    assert set(chip_smoke.VECTOR_KERNELS) == {k["kernel"] for k in clean}
    chip_smoke.check_vector_kernels([*clean, dcn])
    for k in clean:
        for bad in (dict(k, stack_bytes=8), dict(k, spill_loads=4),
                    dict(k, spill_stores=4)):
            others = [o for o in clean if o["kernel"] != bad["kernel"]]
            with pytest.raises(AssertionError, match=bad["kernel"]):
                chip_smoke.check_vector_kernels([bad, *others, dcn])
            # one spilling instance fails even beside a clean one of its kernel
            with pytest.raises(AssertionError, match=bad["kernel"]):
                chip_smoke.check_vector_kernels([*clean, bad, dcn])
        # a kernel missing from the report
        with pytest.raises(AssertionError, match=k["kernel"]):
            chip_smoke.check_vector_kernels(
                [o for o in clean if o is not k] + [dcn])
