"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit).  The benchmark's own table: a roofline or
utilisation share is stated against these, with the card's name and power
limit printed beside every run.
"""
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 494.7e12
BF16_FLOPS = 989.4e12
FP32_CUDA_CORE_FLOPS = 66.9e12
# float32 kept at f32 accuracy on the tensor cores: 3xTF32 (three TF32
# products a multiply), the route the port's own flash kernel takes.  An
# f32 step's utilisation is stated against it, so that moving f32 GEMMs
# from the CUDA cores onto 3xTF32 can never read above 100%.
F32_FLOPS = TF32_FLOPS / 3
