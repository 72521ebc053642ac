"""The TD-VMM kernels' CTA tile per launch shape (GENERATED FILE).

Measured on an NVIDIA H100 and written by ``python -m
repro_torch.launch.autotune_tdvmm``, which times B1 fused at every tile of
``tdvmm.TILES`` after checking every tile bitwise; hand edits last until
its next run.  ``tdvmm.autotune_lookup`` reads it on the card and on the
CPU alike (the plain version ignores the tile); a miss takes
``tdvmm.plan_tile``.

Keys are the unpadded (M, K, N, storage name) of a codes matmul, int4 with
the unpacked K, grouped launches with their lane-rounded concat width;
storage names are "int8", "int4", "float32" (float32 codes on the bf16
tile) and "f32x3" (the 3xTF32 storage).  Values name a tile of
``tdvmm.TILES``.
"""

# fmt: off
HOPPER_TABLE: dict[tuple[int, int, int, str], str] = {
    (4, 1024, 2816, "int8"): "small",
    (4, 2816, 1024, "int8"): "small",
    (8, 128, 64, "float32"): "small",
    (8, 128, 64, "int8"): "small",
    (33, 300, 130, "float32"): "small",
    (64, 512, 2432, "int8"): "small",
    (64, 896, 1152, "int8"): "small",
    (64, 1024, 2816, "int8"): "small",
    (64, 2816, 1024, "int8"): "small",
    (128, 1024, 2816, "int8"): "small",
    (128, 2816, 1024, "int8"): "small",
    (256, 896, 896, "float32"): "small",
    (256, 1024, 512, "int8"): "small",
    (256, 1024, 2816, "int8"): "small",
    (256, 1024, 4096, "int8"): "large",
    (256, 2816, 1024, "int8"): "small",
    (512, 1024, 1024, "int8"): "small",
    (512, 1024, 2816, "int8"): "large",
    (512, 1024, 3072, "int8"): "large",
    (512, 1024, 4096, "float32"): "large",
    (512, 1024, 4096, "int4"): "large",
    (512, 1024, 4096, "int8"): "large",
    (512, 2048, 512, "float32"): "small",
    (512, 2048, 512, "int4"): "small",
    (512, 2048, 512, "int8"): "small",
    (512, 2048, 2048, "int8"): "large",
    (512, 2048, 6144, "int8"): "large",
    (512, 2048, 7168, "int8"): "large",
    (512, 2048, 8192, "int8"): "large",
    (512, 2048, 8576, "int8"): "large",
    (512, 2048, 50432, "int8"): "large",
    (512, 2560, 2560, "int8"): "large",
    (512, 2560, 7680, "int8"): "large",
    (512, 2560, 10240, "int8"): "large",
    (512, 2560, 10624, "int8"): "large",
    (512, 2560, 32000, "int8"): "large",
    (512, 2816, 1024, "int8"): "small",
    (512, 4096, 2048, "int8"): "large",
    (512, 4096, 4096, "int8"): "large",
    (512, 4096, 6144, "int8"): "large",
    (512, 4096, 14336, "int8"): "large",
    (512, 4096, 32000, "int8"): "large",
    (512, 5120, 2560, "int8"): "large",
    (512, 5120, 5120, "int8"): "large",
    (512, 5120, 7168, "int8"): "large",
    (512, 5120, 13824, "int8"): "large",
    (512, 5120, 152064, "int8"): "large",
    (512, 6144, 6144, "int8"): "large",
    (512, 6144, 8192, "int8"): "large",
    (512, 6144, 24576, "int8"): "large",
    (512, 6144, 256000, "int8"): "large",
    (512, 7168, 2048, "int8"): "large",
    (512, 7168, 7168, "int8"): "large",
    (512, 7168, 8960, "int8"): "large",
    (512, 7168, 9216, "int8"): "large",
    (512, 7168, 20480, "int8"): "large",
    (512, 7168, 64000, "int8"): "large",
    (512, 7168, 163840, "int8"): "large",
    (512, 8192, 2048, "int8"): "large",
    (512, 10240, 2560, "int8"): "large",
    (512, 13824, 5120, "int8"): "large",
    (512, 14336, 4096, "int8"): "large",
    (512, 20480, 7168, "int8"): "large",
    (512, 24576, 6144, "int8"): "large",
}
# fmt: on
