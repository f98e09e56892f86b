"""A draw with a raw key, in the reference's idiom (line 8)."""
import jax


def bad_raw_draw(logits, seed):
    # a key made here from the seed alone, with no counter folded in
    key = jax.random.PRNGKey(seed)
    return jax.random.categorical(key, logits)
