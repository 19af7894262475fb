"""The port's tokenization layer against the JAX package's, on the CPU:
XXH64 from the port's native library against ``xxhash``, the prefix
store's chain keys, probes and block-key memo records, the trie store,
the tokenizer backends, the chat render and the pool's tokens, and the
native block-hash chain against the Python chain and the JAX package's.

The library tokenizers (``tokenizers``, ``transformers``) and the chat
render run here only: the H100's machine has neither package."""

import random
import threading

import numpy as np
import pytest
import xxhash

from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as jax_tp
from llm_d_kv_cache_manager_tpu.native import engine as jax_engine
from llm_d_kv_cache_manager_tpu.preprocessing import chat_templating as jax_chat
from llm_d_kv_cache_manager_tpu.tokenization import pool as jax_pool
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as jax_tokenizers
from llm_d_kv_cache_manager_tpu.tokenization.prefixstore import lru_store as jax_store
from llm_d_kv_cache_manager_tpu.tokenization.prefixstore import trie_store as jax_trie
from tests.helpers.tiny_tokenizer import (
    CORPUS,
    build_transformers_tokenizer,
    save_tokenizer_json,
)
from tests.helpers.torch_port import port

native = port("native")
engine = port("native.engine")
tp = port("kvcache.kvblock.token_processor")
store = port("tokenization.prefixstore.lru_store")
trie = port("tokenization.prefixstore.trie_store")
tokenizers = port("tokenization.tokenizers")
pool_mod = port("tokenization.pool")
chat = port("preprocessing.chat_templating")

MODEL = "test-model"
SEEDS = {"zero": 0, "one": 1, "u32_max": 2**32 - 1, "u32_max_plus_1": 2**32,
         "top_bit": 2**63, "u64_max": 2**64 - 1, "random": 0x9E3779B97F4A7C15}


# ------------------------------------------------------------------ xxh64


@pytest.mark.parametrize("seed", list(SEEDS.values()), ids=list(SEEDS))
def test_kvtpu_xxh64_equals_xxhash(seed):
    """Every length 0-1024 (the 32-byte stripes, the 8/4/1-byte tails
    and their mixes), random bytes, at each seed class."""
    rng = np.random.default_rng(seed % 2**32)
    data = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    lib = native.get_library()
    for n in range(1025):
        chunk = data[:n]
        assert lib.kvtpu_xxh64(chunk, n, seed) == xxhash.xxh64_intdigest(chunk, seed), n


TEXTS = {
    "empty": "",
    "short": "hello",
    "ascii": CORPUS * 7,
    "unicode": "naïve café — 東京 🚀 " * 40,
    "words": " ".join(f"t{i * 7919 % 128256}" for i in range(900)),
}


@pytest.mark.parametrize("model", ["", "m", "meta-llama/Llama-3.1-8B"])
@pytest.mark.parametrize("text", list(TEXTS), ids=list(TEXTS))
def test_prefix_store_chain_keys_equal_reference(text, model):
    """The store's chained chunk keys: the port's (native XXH64) equal
    the reference's (``xxhash``) and an explicit ``xxhash`` chain."""
    data = TEXTS[text].encode()
    want, prev = [], xxhash.xxh64(model.encode()).intdigest() if model else 0
    for start in range(0, len(data) - 255, 256):
        prev = xxhash.xxh64_intdigest(prev.to_bytes(8, "little") + data[start:start + 256])
        want.append(prev)
    for size in (256, 64):
        assert store._chunk_hashes(data, model, size) == jax_store._chunk_hashes(
            data, model, size)
    assert store._chunk_hashes(data, model, 256) == want
    assert store._chain_seed(model) == jax_store._chain_seed(model)


def _word_encoding(prompt):
    tokens, offsets, pos = [], [], 0
    for word in prompt.split(" "):
        tokens.append(int(word[1:]))
        offsets.append((pos, pos + len(word)))
        pos += len(word) + 1
    return tokens, offsets


def test_prefix_store_probes_and_memo_records_equal_reference():
    """One seeded sequence of tokenizations, block-key attaches and
    probes through both LRU stores (a small cache, so chunks are
    evicted): every probe (tokens, coverage, memo keys, memo blocks)
    and every attach count equal.  A re-split of a shared chunk by an
    overlapping prompt's tokenization installs fresh token tuples, and
    both stores then refuse the record anchored on the old ones."""
    rng = np.random.default_rng(5)
    stores = {"jax": jax_store.LRUTokenStore(jax_store.LRUStoreConfig(cache_size=300,
                                                                      block_size=64)),
              "port": store.LRUTokenStore(store.LRUStoreConfig(cache_size=300, block_size=64))}
    key_space = (12345, 4)
    base = [int(t) for t in rng.integers(1, 50_000, 200)]
    prompts = []
    for step in range(60):
        n = int(rng.integers(20, 400))
        tokens = base[:min(n, len(base))] + [int(t) for t in rng.integers(1, 50_000, max(
            0, n - len(base)))]
        if rng.random() < 0.3:
            tokens = [int(t) for t in rng.integers(1, 50_000, n)]
        prompt = " ".join(f"t{t}" for t in tokens)
        prompts.append(prompt)
        toks, offs = _word_encoding(prompt)
        results = {}
        for name, s in stores.items():
            s.add_tokenization(prompt, toks, offs, "m")
            probe = s.probe(prompt, "m", key_space)
            keys = [rng_key for rng_key in range(len(probe.tokens) // 4)]
            attached = s.attach_block_keys(prompt, "m", key_space, keys, probe.tokens,
                                           min_blocks=step % 3)
            results[name] = (probe, attached, s.probe(prompts[int(step * 7 % len(prompts))],
                                                      "m", key_space))
        assert results["port"] == results["jax"], step
    # The identity rule: overwrite a shared chunk with another split.
    prompt = "t1 t2 t3 t4 " * 40
    toks, offs = _word_encoding(prompt.strip())
    for s in stores.values():
        s.add_tokenization(prompt, toks, offs, "x")
        probe = s.probe(prompt, "x", key_space)
        s.attach_block_keys(prompt, "x", key_space, list(range(len(probe.tokens) // 4)),
                            probe.tokens)
        assert s.probe(prompt, "x", key_space).blocks > 0
        s.add_tokenization(prompt, list(toks), list(offs), "x")  # same values, new tuples
        assert s.probe(prompt, "x", key_space).blocks == 0


def test_trie_store_equals_reference():
    rng = random.Random(3)
    stores = {"jax": jax_trie.TrieTokenStore(max_depth_bytes=512),
              "port": trie.TrieTokenStore(max_depth_bytes=512)}
    for _ in range(30):
        prompt = " ".join(f"t{rng.randrange(1, 40)}" for _ in range(rng.randrange(1, 120)))
        toks, offs = _word_encoding(prompt)
        cut = rng.randrange(1, len(prompt) + 1)
        got = {}
        for name, s in stores.items():
            s.add_tokenization(prompt, toks, offs, "m")
            got[name] = (s.probe(prompt[:cut], "m"),
                         s.find_longest_contained_tokens(prompt, "m"))
        assert tuple(got["port"][0]) == tuple(got["jax"][0]) and got["port"][1] == got["jax"][1]


# ------------------------------------------------------------- tokenizers


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    return save_tokenizer_json(str(tmp_path_factory.mktemp("tok")), MODEL)


PROMPTS = [CORPUS, "the quick brown fox", "hello world . " * 30, "naïve 東京 fox dog",
           "", "user says hello world . " * 3]


def test_local_fast_tokenizer_equals_reference(tokenizer_dir):
    """Tokens and byte offsets of the tiny tokenizer.json, special
    tokens on and off, and the char-to-byte offset conversion."""
    ours = tokenizers.LocalFastTokenizer(tokenizer_dir)
    ref = jax_tokenizers.LocalFastTokenizer(tokenizer_dir)
    for prompt in PROMPTS:
        for special in (True, False):
            assert vars(ours.encode(prompt, MODEL, special)) == vars(
                ref.encode(prompt, MODEL, special))
        offsets = [(i, i + 2) for i in range(0, len(prompt), 3)]
        assert tokenizers.char_offsets_to_byte_offsets(prompt, offsets) == (
            jax_tokenizers.char_offsets_to_byte_offsets(prompt, offsets))
    with pytest.raises(Exception):
        ours.encode("x", "no-such-model", True)


def test_transformers_and_composite_tokenizers_equal_reference(tokenizer_dir):
    """``TransformersTokenizer`` over the tiny wrapped tokenizer (placed in
    its cache, so nothing is fetched), and ``CompositeTokenizer`` falling
    back past a failing backend."""

    class Failing:
        def type(self):
            return "failing"

        def encode(self, prompt, model_name, add_special_tokens):
            raise RuntimeError("down")

    wrapped = build_transformers_tokenizer()
    backends = {}
    for name, mod in (("jax", jax_tokenizers), ("port", tokenizers)):
        hf = mod.TransformersTokenizer()
        hf._cache[MODEL] = wrapped
        backends[name] = (hf, mod.CompositeTokenizer(
            [Failing(), mod.LocalFastTokenizer(tokenizer_dir)]))
    for prompt in PROMPTS:
        for i in range(2):
            assert vars(backends["port"][i].encode(prompt, MODEL, True)) == vars(
                backends["jax"][i].encode(prompt, MODEL, True))
    assert backends["port"][1].type() == backends["jax"][1].type()
    with pytest.raises(RuntimeError, match="all tokenizer backends failed"):
        tokenizers.CompositeTokenizer([Failing()]).encode("x", MODEL, True)


def test_chat_render_equals_reference():
    conversation = [{"role": "system", "content": "you are a helpful assistant ."},
                    {"role": "user", "content": "hello world"}]
    rendered = []
    for mod in (jax_chat, chat):
        processor = mod.ChatTemplatingProcessor()
        processor.register_tokenizer(MODEL, build_transformers_tokenizer())
        rendered.append(processor.apply_chat_template(
            MODEL, mod.ApplyChatTemplateRequest(conversation=conversation)))
    assert rendered[0] == rendered[1] and "<|user|> hello world" in rendered[1]


def test_pool_tokens_and_memo_keys_equal_reference(tokenizer_dir):
    """Both pools over the tiny tokenizer: the tokens of each prompt
    (full encodes, then prefix-store fast paths), the served text and
    memo keys; ``shutdown`` joins every worker."""
    pools = {}
    try:
        for name, mod, tok_mod, store_mod in (
                ("jax", jax_pool, jax_tokenizers, jax_store),
                ("port", pool_mod, tokenizers, store)):
            pools[name] = mod.TokenizationPool(
                tok_mod.LocalFastTokenizer(tokenizer_dir),
                store_mod.LRUTokenStore(store_mod.LRUStoreConfig(block_size=32)),
                mod.TokenizationPoolConfig(workers=3, model_name=MODEL))
            pools[name].start()
        for prompt in PROMPTS * 2 + [p + " extra words here" for p in PROMPTS]:
            got = {name: vars(pool.tokenize_with_keys(prompt, MODEL, key_space=(1, 4)))
                   for name, pool in pools.items()}
            assert got["port"] == got["jax"], prompt
            assert pools["port"].tokenize(prompt, MODEL) == pools["jax"].tokenize(prompt, MODEL)
    finally:
        for pool in pools.values():
            pool.shutdown()
    assert not [t for t in threading.enumerate() if t.name.startswith("kvtpu-tokenize")]


# ------------------------------------------------------- native hash chain


@pytest.mark.parametrize("block_size", [1, 4, 16])
def test_native_hash_chain_equals_python_and_reference(block_size):
    rng = np.random.default_rng(block_size)
    python_db = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=block_size),
                                        use_native=False)
    native_db = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=block_size))
    for trial in range(20):
        tokens = [int(t) for t in rng.integers(0, 2**32, int(rng.integers(0, 300)))]
        parent = int(rng.integers(0, 2**63)) if trial % 2 else python_db.model_init_hash("m")
        keys = engine.native_hash_chain(parent, tokens, block_size)
        assert keys == jax_engine.native_hash_chain(parent, tokens, block_size)
        assert keys == python_db.extend_block_keys(parent, tokens, "m")
        assert (native_db.tokens_to_kv_block_keys(0, tokens, "m")
                == python_db.tokens_to_kv_block_keys(0, tokens, "m"))
    assert native_db._native_chain is engine.native_hash_chain
    assert python_db._native_chain is None


@pytest.mark.parametrize("tokens", [[5, -1] * 8, [2**32] * 16, [2**40, 3] * 8, [1.5] * 16],
                         ids=["negative", "u32_max_plus_1", "huge", "float"])
def test_out_of_range_ids_take_the_python_chain(tokens):
    """Ids outside uint32 (or not integers) would wrap in the native
    chain: ``native_hash_chain`` declines them and the token processor's
    keys are the Python chain's, as in the reference."""
    assert engine.native_hash_chain(7, tokens, 4) is None
    assert jax_engine.native_hash_chain(7, tokens, 4) is None
    if all(isinstance(t, int) and t >= 0 for t in tokens):
        cfg = dict(block_size=4, hash_seed="9")
        ours = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(**cfg))
        ref = jax_tp.ChunkedTokenDatabase(jax_tp.TokenProcessorConfig(**cfg), use_native=False)
        assert ours.tokens_to_kv_block_keys(0, tokens, "m") == ref.tokens_to_kv_block_keys(
            0, tokens, "m")
