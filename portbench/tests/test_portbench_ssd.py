"""The `ssd_kernel_ms.pod` reader on hand-made traces: the SSD kernels'
device time per traced round, and None without such a kernel (the
einsum chain's program) or without traced rounds."""
import types

import pytest

from portbench.harness import spec

READ = spec.metric_reader("ssd_kernel_ms.pod").read


def ctx(rows, rounds=2):
    return {"trace": types.SimpleNamespace(device=rows, host=[],
                                           window=(0.0, 1e6)),
            "trace_rounds": rounds}


@pytest.mark.parametrize("rows, rounds, want", [
    # forward and backward kernels of two layers over two rounds
    ([("ssd_chunk_scan_kernel", 0.0, 300.0),
      ("ssd_bwd_dcb_kernel", 400.0, 500.0),
      ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 900.0, 800.0),
      ("ssd_chunk_scan_kernel", 2000.0, 300.0)], 2, 0.55),
    # the einsum chain: GEMMs and elementwise kernels only
    ([("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 0.0, 800.0),
      ("void at::native::elementwise_kernel", 900.0, 50.0)], 2, None),
    ([("ssd_cumsum_kernel", 0.0, 5.0)], 0, None),
    ([], 2, None),
])
def test_ssd_kernel_ms(rows, rounds, want):
    got = READ(ctx(rows, rounds))
    assert got == (None if want is None else pytest.approx(want))
