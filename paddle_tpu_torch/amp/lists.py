"""AMP op lists (reference fluid/contrib/mixed_precision/fp16_lists.py +
imperative/amp_auto_cast.cc AmpOperators).

Copy of ``paddle_tpu/amp/lists.py`` (the JAX package's module imports no
JAX); the program it builds is the same, op for op.

White = compute-bound, run in low precision (MXU ops).  Black = numerically
sensitive, keep fp32.  Gray = follow their inputs.
"""

WHITE_LIST = {
    "conv2d", "depthwise_conv2d", "conv2d_transpose", "matmul", "matmul_v2",
    "mul", "bmm", "fc", "fused_multihead_attention",
}

BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "cross_entropy2", "log_softmax",
    "reduce_sum", "reduce_mean", "p_norm", "frobenius_norm",
    "group_norm",
    "instance_norm", "update_loss_scaling", "check_finite_and_unscale",
}

# gray ops whose fp32 inputs are cast down once another input is already
# low precision (reference fp16_utils.py:193 does this for every gray op).
# Without it jnp type promotion silently lifts bf16+fp32 -> fp32, and the
# fp32 poison spreads down the whole residual stream: bias adds after
# white matmuls, residual adds, and every backward dot then runs fp32 on
# the vector units instead of bf16 on the MXU (~8x slower).
GRAY_FOLLOW_CAST = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "concat", "stack", "where",
}

# batch_norm/sync_batch_norm/layer_norm/softmax are deliberately NOT
# black on TPU: their lowerings compute in fp32 internally and return Y
# in the input dtype, so keeping them gray lets the activation chain
# (conv->bn->relu->pool, matmul->layer_norm->gelu, attention
# scores->softmax->context) stay bf16 end-to-end — halving HBM traffic vs
# the reference's fp32 black-listing, which exists for CUDA kernel
# reasons we don't have (fp16_lists.py keeps them black).

# everything else is gray: it runs in whatever dtype its inputs carry


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        self.gray_follow_cast = set(GRAY_FOLLOW_CAST)
        self.black_varnames = set(custom_black_varnames or [])
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
