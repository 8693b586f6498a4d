"""Operations and bytes each op needs, one module an op, computed from the
shapes of its call: products as fused multiply-adds, each input read once
and each output written once, no recomputation, a symmetric Gram matrix
counted once. The count is the same whatever implements the op."""
