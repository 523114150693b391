"""Tokenizers and datasets from local paths: the port's `load_tokenizer` and
`get_custom_dataset` against the JAX package's.

- A tokenizer directory built here with `tokenizers` (a WordLevel model,
  and a `tokenizer_config.json` with a chat template) loads in both
  packages through `transformers.AutoTokenizer`; ids of text and of the
  chat template are equal.
- GSM8K-, MATH- and HH-RLHF-shaped rows are written to jsonl under
  `tmp_path`. `datasets.load_dataset` is replaced by a reader of those
  files that records each call, so no hub id is ever fetched: both
  packages must ask for the same (path, config, split), and their rl, sft
  and rw items must be equal.
- The code and vision datasets load as JAX's do: the code benchmarks and
  `clevr_count_70k` / `geometry3k` from local rows, `synthetic-vision`
  from its seed, bit for bit. Sharding over hosts is refused with its
  ROADMAP item.
"""

import json
import os

import numpy as np
import pytest

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import datasets as hf_datasets  # noqa: E402

from areal_tpu import dataset as jd  # noqa: E402
from areal_tpu_torch import dataset as td  # noqa: E402

WORDS = ["[PAD]", "[UNK]", "<s>", "</s>", "what", "is", "2", "+", "3", "?", "the", "answer",
         "5", "user:", "assistant:", "half", "of", "ten", "good", "bad", "reply", "####"]
CHAT = ("{% for m in messages %}{{ m['role'] }}: {{ m['content'] }} {% endfor %}"
        "{% if add_generation_prompt %}assistant: {% endif %}")


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]",
                                   bos_token="<s>", eos_token="</s>")
    d = tmp_path_factory.mktemp("tok")
    fast.save_pretrained(d)
    cfg_path = d / "tokenizer_config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["chat_template"] = CHAT
    cfg_path.write_text(json.dumps(cfg))
    return str(d)


def test_load_tokenizer_from_a_local_directory(tok_dir):
    jt, tt = jd.load_tokenizer(tok_dir), td.load_tokenizer(tok_dir)
    assert type(tt).__name__ == type(jt).__name__
    assert tt.eos_token_id == jt.eos_token_id == 3
    text = "what is 2 + 3 ? the answer is 5 zebra"
    assert tt.encode(text) == jt.encode(text)
    assert tt.encode(text)[-1] == 1  # [UNK]
    msgs = [{"role": "user", "content": "what is half of ten ?"}]
    ids = tt.apply_chat_template(msgs, add_generation_prompt=True, tokenize=True)
    assert ids == jt.apply_chat_template(msgs, add_generation_prompt=True, tokenize=True)
    assert ids[0] == WORDS.index("user:") and ids[-1] == WORDS.index("assistant:")
    assert tt.decode(ids) == jt.decode(ids)


def test_offline_sentinels_get_the_arithmetic_tokenizer():
    for path in ("", "synthetic-arith", "arith"):
        assert type(td.load_tokenizer(path)).__name__ == "ArithTokenizer"


GSM8K = [dict(question="what is 2 + 3 ?", answer="2 + 3 = 5\n#### 5"),
         dict(question="half of ten ?", answer="ten / 2\n#### 5"),
         dict(question="what is 2 ?", answer="#### 2")]
MATH = [dict(problem="What is 2+2?", solution=r"easy: \boxed{4}", answer="4"),
        dict(problem="Half?", solution=r"\boxed{\frac{1}{2}}", answer=None),
        dict(problem="Root?", solution=r"so $\boxed{\sqrt{2}}$", answer="")]
HH = [dict(chosen="user: what is 2 ? assistant: good reply",
           rejected="user: what is 2 ? assistant: bad reply"),
      dict(chosen="good", rejected="bad bad")]
TORL = [dict(question="what is 2 + 3 ?", answer="5"), dict(question="half of ten ?", answer="5")]
TORL_PROBLEMS = [dict(problem="half of ten ?", solution="5")]


@pytest.fixture
def local_hub(tmp_path, monkeypatch):
    """jsonl files per (name, split) under tmp_path, and a `load_dataset`
    that reads them and records its calls."""
    files = {}

    def write(name, rows, split="train"):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        path = d / f"{split}.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in rows))
        files[(name, split)] = path
        return str(d)

    calls = []

    def load_dataset(path, name=None, split=None, **kw):
        calls.append((path, name, split))
        key = (os.path.basename(path.rstrip("/")), split)
        if key not in files:
            raise FileNotFoundError(f"no local rows for {path!r} split {split!r}")
        rows = [json.loads(ln) for ln in files[key].read_text().splitlines()]
        return hf_datasets.Dataset.from_list(rows)

    monkeypatch.setattr(hf_datasets, "load_dataset", load_dataset)
    return write, calls


def _both(calls, **kw):
    n = len(calls)
    j = list(jd.get_custom_dataset(**kw))
    jcalls = calls[n:]
    t = list(td.get_custom_dataset(**kw))
    assert calls[n + len(jcalls):] == jcalls
    return t, j, jcalls


def test_gsm8k_rl_and_sft_views_from_a_local_directory(local_hub, tok_dir):
    write, calls = local_hub
    path = write("gsm8k", GSM8K, "test")
    t, j, asked = _both(calls, path=path, split="test", type="rl")
    assert asked == [(path, None, "test")]
    assert t == j and [x["answer"] for x in t] == ["5", "5", "2"]
    assert t[0]["messages"] == [{"role": "user", "content": "what is 2 + 3 ?"}]
    tok = td.load_tokenizer(tok_dir)
    t, j, _ = _both(calls, path=path, split="test", type="sft", tokenizer=tok, max_length=6)
    assert t == j and all(len(x["input_ids"]) <= 6 for x in t)


def test_gsm8k_canonical_hub_id(local_hub):
    write, calls = local_hub
    write("gsm8k", GSM8K, "train")
    for path in ("gsm8k", "openai/gsm8k"):
        t, j, asked = _both(calls, path=path, split="train", type="rl")
        assert asked == [("openai/gsm8k", "main", "train")] and t == j


@pytest.mark.parametrize("name,hub", [
    ("math500", "HuggingFaceH4/MATH-500"), ("math-500", "HuggingFaceH4/MATH-500"),
    ("aime", "AI-MO/aimo-validation-aime"), ("aime24", "math-ai/aime24"),
    ("aime25", "math-ai/aime25"),
])
def test_math_datasets(local_hub, name, hub):
    write, calls = local_hub
    write(hub.split("/")[-1], MATH, "test")
    t, j, asked = _both(calls, path=name, split="test", type="rl")
    assert asked == [(hub, None, "test")]
    assert t == j
    assert [x["answer"] for x in t] == ["4", r"\frac{1}{2}", r"\sqrt{2}"]


def test_math_items_mapper_equals_jax():
    ds = hf_datasets.Dataset.from_list(MATH)
    assert list(td._math_items(ds)) == list(jd._math_items(ds))


def test_hh_rlhf_rw_view(local_hub, tok_dir):
    write, calls = local_hub
    write("hh-rlhf", HH, "train")
    local = write("my-prefs", HH, "train")
    tok = td.load_tokenizer(tok_dir)
    t, j, asked = _both(calls, path="hh-rlhf", split="train", type="rw", tokenizer=tok,
                        max_length=8)
    assert asked == [("Anthropic/hh-rlhf", None, "train")]
    assert t == j and len(t[0]["chosen_input_ids"]) == 8
    # a registry name read from a local mirror: hh-rlhf's last path part
    t, j, asked = _both(calls, path=os.path.join(local, "..", "hh-rlhf"), split="train",
                        type="rw")
    assert t == j and "chosen_input_ids" not in t[0]


def test_torl_data(local_hub):
    write, calls = local_hub
    path = write("torl_data", TORL, "train")
    t, j, asked = _both(calls, path=path, split="train", type="rl")
    assert asked == [(path, None, "train")]
    assert t == j and [x["prompt"] for x in t] == ["what is 2 + 3 ?", "half of ten ?"]
    path = write("torl_data", TORL_PROBLEMS, "test")
    t, j, _ = _both(calls, path=path, split="test", type="rl")
    assert t == j and t[0]["prompt"] == "half of ten ?" and t[0]["answer"] == "5"


def test_unregistered_name_goes_to_load_dataset(local_hub):
    write, calls = local_hub
    path = write("some-rows", TORL, "train")
    t, j, asked = _both(calls, path=path, split="train", type="rl")
    assert asked == [(path, None, "train")] and t == j == TORL


CODE_HUBS = {"humaneval": "openai/openai_humaneval",
             "openai/openai_humaneval": "openai/openai_humaneval",
             "mbpp": "google-research-datasets/mbpp"}


VQA_ROWS = {
    "clevr_count_70k": [dict(problem="How many spheres?", image="img0.png", answer=3),
                        dict(question="How many cubes?", image="img1.png", answer=2)],
    "geometry3k": [dict(problem="Find x.", images=["a.png", "b.png"], answer="B"),
                   dict(problem="Find the area.", images=["c.png"], answer="12\\sqrt{3}")],
}


def _vision_items_equal(t: list, j: list) -> None:
    """Items equal, arrays bit for bit (dtype and bytes)."""
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert set(a) == set(b) and a["input_ids"] == b["input_ids"]
        assert a["answer"] == b["answer"] and len(a["images"]) == len(b["images"]) == 1
        for k in ("pixel_values", "image_grid_thw"):
            x, y = a["images"][0][k], b["images"][0][k]
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name", ["humaneval", "openai/openai_humaneval", "mbpp",
                                  "clevr_count_70k", "geometry3k", "synthetic-vision"])
def test_code_and_vision_datasets(name, local_hub):
    """The code benchmarks: a name that is no local file goes to its hub
    id through `load_dataset` (here the recording reader), as in JAX. The
    vision datasets: `clevr_count_70k` and `geometry3k` read a local
    directory given as the path and map its rows to {messages, images,
    answer} as JAX does; `synthetic-vision` gives JAX's items for the
    same seed and split, arrays bit for bit."""
    write, calls = local_hub
    if name == "synthetic-vision":
        for split, seed in (("train", 0), ("test", 5)):
            t = td.get_custom_dataset(path=name, split=split, n_items=16, seed=seed)
            j = jd.get_custom_dataset(path=name, split=split, n_items=16, seed=seed)
            _vision_items_equal(t, j)
        assert t[0]["input_ids"] == [5, 31, 31, 31, 31, 9, 2]
        assert {x["answer"] for x in t} <= {"1", "2", "3", "4"}
        return
    if name in VQA_ROWS:
        path = write(name, VQA_ROWS[name], "test")
        t, j, asked = _both(calls, path=path, split="test", type="rl")
        assert asked == [(path, None, "test")] and t == j
        q = t[0]["messages"][0]["content"]
        assert q[0] == {"type": "image"} and q[1]["type"] == "text"
        assert [str(x["answer"]) for x in t] == [str(r["answer"]) for r in VQA_ROWS[name]]
        assert t[0]["images"] == VQA_ROWS[name][0].get("images", ["img0.png"])
        return
    hub = CODE_HUBS[name]
    rows = [dict(task_id="T/0", prompt="def f():\n", entry_point="f",
                 test="def check(c):\n    assert c() is None\n", text="f", code="",
                 test_list=["assert f() is None"], test_setup_code="")]
    write(hub.split("/")[-1], rows, "test")
    t, j, asked = _both(calls, path=name, split="test", type="rl")
    assert t == j and len(t) == 1 and "input_output" in t[0]
    assert [a[0] for a in asked] == [hub]


def test_sharding_over_hosts_is_refused():
    with pytest.raises(NotImplementedError, match="item 5"):
        td.get_custom_dataset(path="countdown", world_size=2, rank=1)


def _checkpoint(path, vocab: int) -> str:
    """A smoke-sized HF checkpoint written by the port (random weights)."""
    import torch

    from areal_tpu_torch.models import hf_io
    from areal_tpu_torch.models.qwen2 import ModelConfig, init_params
    from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT

    hf = dict(model_type="qwen2", **dict(SMOKE_MODEL_DICT, vocab_size=vocab))
    mc = ModelConfig.from_hf_config(hf, dtype="float32", param_dtype="float32",
                                    scan_layers=False)
    hf_io.save_hf_params(init_params(mc, torch.Generator().manual_seed(3)), mc, str(path))
    (path / "config.json").write_text(json.dumps(hf))
    return str(path)


def test_sft_and_rw_entry_points_on_local_data(local_hub, tok_dir, tmp_path):
    """The SFT entry point on the gsm8k SFT view and the reward-model entry
    point on the hh-rlhf view, each with a local tokenizer and the model
    loaded from `model.path` (the reward model's value head starting at
    zero on a causal LM's trunk), 2 steps each on the CPU."""
    from areal_tpu_torch.examples import gsm8k_sft, hhrlhf_rw

    write, calls = local_hub
    gsm = write("gsm8k", GSM8K + GSM8K[:1], "train")
    write("gsm8k", GSM8K + GSM8K[:1], "test")
    hh = write("hh-rlhf", HH * 2, "train")
    write("hh-rlhf", HH * 2, "test")
    ckpt = _checkpoint(tmp_path / "ckpt", vocab=32)
    common = [f"cluster.fileroot={tmp_path}", f"tokenizer_path={tok_dir}",
              f"model.path={ckpt}", "model.init_from_scratch=false", "total_train_steps=2",
              "train_dataset.batch_size=2", "valid_dataset.batch_size=2",
              "evaluator.freq_steps=null"]
    sft = gsm8k_sft.main(["--config", "examples/configs/arith_sft_smoke.yaml", *common,
                          f"train_dataset.path={gsm}", f"valid_dataset.path={gsm}"],
                         device="cpu")
    assert len(sft) == 2 and all(np.isfinite(r["loss"]) for r in sft)
    rw = hhrlhf_rw.main(["--config", "examples/configs/arith_rw_smoke.yaml", *common,
                         f"train_dataset.path={hh}", f"valid_dataset.path={hh}"],
                        device="cpu")
    assert len(rw) == 2 and all(np.isfinite(r["loss"]) for r in rw)
    assert (gsm, None, "train") in calls and (hh, None, "train") in calls
