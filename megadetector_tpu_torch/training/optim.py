"""
The optax gradient transformations that the JAX trainers build
(training/train_classifier.py, classification/train_classifier.py,
training/train_detector.py's tests), in PyTorch, with optax's arithmetic:
clip_by_global_norm, scale_by_adam, add_decayed_weights, adam, adamw,
chain and masked, and apply_updates.

A transformation is a pair of functions over lists of tensors (one per
parameter, in one fixed order): init(params) -> state and
update(grads, state, params) -> (updates, state). Optimizer holds one with
its parameters and steps them from their .grad.

Where this is not torch.optim: Adam's update here is optax's,
mu_hat / (sqrt(nu_hat) + eps) with both moments bias-corrected by
division, the bias correction 1 - b ** count computed in float32 as XLA
computes it; torch.optim.Adam folds the corrections into the step size
and the denominator, which rounds differently. Clipping is optax's rule,
(g / norm) * max_norm where norm >= max_norm;
torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6.

masked differs from optax.masked on purpose: a leaf outside the mask gets
a zero update (its parameter is left as it is, and it holds no moments).
optax.masked passes such a leaf's incoming update through unchanged, so
the JAX classification trainer's finetune mode adds the raw gradient to
its frozen parameters.
"""

import torch


class GradientTransformation:
    """init(params) -> state; update(grads, state, params) ->
    (updates, state). Lists of tensors throughout."""

    def __init__(self, init, update):
        self.init = init
        self.update = update


def _bias_correction(decay, count):
    """1 - decay ** count in float32, as XLA computes it (a float32 power
    of the float32 decay), as a Python float."""

    b = torch.tensor(decay, dtype=torch.float32)
    return float(1 - b ** torch.tensor(float(count), dtype=torch.float32))


def global_norm(grads):
    """optax.global_norm: the square root of every leaf's float32 sum of
    squares, added (each sum in torch's order, not XLA's)."""

    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(max_norm):
    """optax.clip_by_global_norm: where global_norm is at least max_norm,
    every update becomes (g / norm) * max_norm."""

    def init(params):
        return ()

    def update(grads, state, params=None):
        norm = global_norm(grads)
        if bool(norm < max_norm):
            return grads, state
        return [(g / norm) * max_norm for g in grads], state

    return GradientTransformation(init, update)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8):
    """optax.scale_by_adam (eps_root 0, no Nesterov): state (count, mu,
    nu), float32 moments like the parameters."""

    def init(params):
        return {'count': 0,
                'mu': [torch.zeros_like(p) for p in params],
                'nu': [torch.zeros_like(p) for p in params]}

    def update(grads, state, params=None):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state['mu'])]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state['nu'])]
        count = state['count'] + 1
        bc1 = _bias_correction(b1, count)
        bc2 = _bias_correction(b2, count)
        updates = [(m / bc1) / (torch.sqrt(v / bc2) + eps)
                   for m, v in zip(mu, nu)]
        return updates, {'count': count, 'mu': mu, 'nu': nu}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay):
    """optax.add_decayed_weights: g + weight_decay * p."""

    def init(params):
        return ()

    def update(grads, state, params):
        return [g + weight_decay * p for g, p in zip(grads, params)], state

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate):
    """optax.scale_by_learning_rate: g * -learning_rate."""

    def init(params):
        return ()

    def update(grads, state, params=None):
        return [g * -learning_rate for g in grads], state

    return GradientTransformation(init, update)


def chain(*transforms):
    """optax.chain: each transformation's updates feed the next."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam."""

    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    """optax.adamw (weight decay on every leaf)."""

    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def masked(inner, mask):
    """[inner] over the leaves whose [mask] entry is True (it sees only
    those, in order, and keeps state only for them); every other leaf gets
    a zero update (see the module docstring for optax.masked)."""

    mask = [bool(m) for m in mask]

    def pick(xs):
        return [x for x, m in zip(xs, mask) if m]

    def init(params):
        return inner.init(pick(params))

    def update(grads, state, params=None):
        inner_updates, state = inner.update(
            pick(grads), state, None if params is None else pick(params))
        it = iter(inner_updates)
        return [next(it) if m else torch.zeros_like(g)
                for g, m in zip(grads, mask)], state

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """optax.apply_updates, in place: p = p + u."""

    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))


class Optimizer:
    """A transformation bound to a list of parameters: step() applies it
    to their gradients (.grad; a parameter without one counts as a zero
    gradient)."""

    def __init__(self, params, transform):
        self.params = list(params)
        self.transform = transform
        with torch.no_grad():
            self.state = transform.init([p.detach() for p in self.params])

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        with torch.no_grad():
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in self.params]
            updates, self.state = self.transform.update(
                grads, self.state, [p.detach() for p in self.params])
            apply_updates(self.params, updates)
