"""One module a model family: how the harness calls the program's entry
points for it, and the plain reference of its residual. A configuration
names its family ("family" in configs/*.json). `normalized` and
`null_vector` are the families' common part of their reference `refit`."""


def normalized(points, dtype):
    """Hartley normalization of points [n, 2] in `dtype`: (centred
    points scaled to mean distance sqrt(2), T [3, 3] float64)."""
    import torch

    p = points.to(dtype)
    centre = p.mean(0)
    d = p - centre
    scale = 2.0 ** 0.5 / torch.sqrt((d * d).sum(1)).mean()
    c, s = centre.double(), float(scale)
    t = torch.tensor([[s, 0.0, -s * float(c[0])], [0.0, s, -s * float(c[1])],
                      [0.0, 0.0, 1.0]], dtype=torch.float64)
    return d * scale, t


def null_vector(a):
    """The unit vector v minimizing |a v|, from the eigenvectors of a^T a;
    a^T a is formed in the dtype of `a`, the 9 x 9 eigenproblem solved in
    float64, or in float32 below it (torch solves none in bfloat16)."""
    import torch

    m = a.T @ a
    solve = torch.float64 if m.dtype == torch.float64 else torch.float32
    return torch.linalg.eigh(m.to(solve))[1][:, 0].double()

