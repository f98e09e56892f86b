"""The reference's idiom of rng_bad.py's first defect, on the same line
(8): a draw with a raw key."""
import jax


def bad_raw_draw(logits, seed):
    key = jax.random.PRNGKey(seed)
    return jax.random.categorical(key, logits)
