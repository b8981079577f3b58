"""The plain reference of a decision tree's prediction: each input walks
the tree from the root with integer comparisons.

It imports `torch` alone (no JAX, no kernel, no IR), so it is
independent of the lowering it checks (`repro_torch.fhe_ml.trees`).
Where it departs from scikit-learn's `DecisionTreeClassifier.predict`:

  * features are quantized: unsigned integers of the tree's `in_bits`
    bits, and thresholds integers in [1, 2^in_bits - 1];
  * a node sends x right when x[feature] >= threshold (scikit-learn
    sends it left when x[feature] <= its float threshold, here t - 0.5);
  * a leaf holds its class, not the class counts, and the walk returns
    the one-hot leaf beside it, leaves in node-id order.

`tree` is any object with scikit-learn's arrays `left`, `right`,
`feature`, `threshold` and `value` (as `trees.DecisionTree`), -1 in
`left` marking a leaf.
"""
import torch


def predict(tree, x) -> tuple:
    """(B, features) integer features -> ((B, leaves) one-hot int64,
    (B,) class int64), on x's device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.as_tensor(x, dtype=torch.int64)
    x = x.reshape(-1, x.shape[-1])
    leaves = [v for v in range(len(tree.left)) if tree.left[v] < 0]
    column = {v: j for j, v in enumerate(leaves)}
    onehot = torch.zeros((x.shape[0], len(leaves)), dtype=torch.int64)
    cls = torch.zeros(x.shape[0], dtype=torch.int64)
    for b, row in enumerate(x.tolist()):
        v = 0
        while tree.left[v] >= 0:
            v = tree.right[v] if row[tree.feature[v]] >= tree.threshold[v] else tree.left[v]
        onehot[b, column[v]] = 1
        cls[b] = tree.value[v]
    return onehot.to(x.device), cls.to(x.device)
