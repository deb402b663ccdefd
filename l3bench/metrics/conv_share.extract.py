"""Share of the device's operation time in the traced stretch that
the audio tower's forward convolutions (cuDNN's implicit-GEMM and CUTLASS kernels, and the kernels of its FFT convolution: the ``DSE::`` transforms, the pointwise complex products, the filter flips); the rest is the front end, the BatchNorms, casts, pools and copies, in %. A kernel counts as a
convolution when its name matches CONV, cuDNN's and CUTLASS's names for
them; cuDNN's layout transposes do not."""

from l3bench import readers

CONV = (r"fprop|dgrad|wgrad|implicit_gemm|ImplicitGemmConvolution|implicit_convolve|convolve_|winograd|"
        r"fft2d_|DSE::|pointwise_mult_and_sum_complex|flip_filter")


def read(rec):
    return readers.op_share(rec, CONV)
