"""Model FLOPs of one ResNet-50 v1.5 training step, counted from the shapes.

Forward multiply-adds of every convolution and of the classifier, each
counted as 2 FLOPs; a training step is 3 forward passes (the backward
computes two products for each forward one). Batch norm, ReLU, pooling and
the loss are left out, as model FLOPs leave them out.
"""


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one image's forward pass."""
    size = int(cfg["image_size"])
    width = int(cfg["num_filters"])
    macs = 0

    def conv(hw: int, cin: int, cout: int, k: int, stride: int) -> int:
        nonlocal macs
        out = (hw + stride - 1) // stride
        macs += out * out * cout * cin * k * k
        return out

    hw = conv(size, 3, width, 7, 2)          # stem
    hw = (hw + 1) // 2                       # max-pool 3x3/2
    cin = width
    for stage, blocks in enumerate(cfg["stage_sizes"]):
        filters = width * 2 ** stage
        for j in range(blocks):
            stride = 2 if stage > 0 and j == 0 else 1
            conv(hw, cin, filters, 1, 1)
            out = conv(hw, filters, filters, 3, stride)   # v1.5: stride here
            conv(out, filters, 4 * filters, 1, 1)
            if stride != 1 or cin != 4 * filters:
                conv(hw, cin, 4 * filters, 1, stride)
            hw, cin = out, 4 * filters
    return macs + cin * int(cfg["num_classes"])


def step_flops(cfg: dict, batch: int) -> float:
    return 3.0 * 2.0 * forward_macs(cfg) * batch
