"""The port's tokenizer (``utils/hf_tokenizer.py``) against transformers'
``AutoTokenizer.from_pretrained`` of the same local directory, which is
what the JAX package's worker loads for ``tokenizer_id``.

Three byte-level BPE tokenizers are built in a temp directory with the
``tokenizers`` library (merges trained on the repo's README): a Llama 3-style
one (its split regex, ``ignore_merges``, a BOS template, specials past a
vocab small enough for the tiny models, ``clean_up_tokenization_spaces``, the
template in ``chat_template.jinja``), a Qwen 2.5-style one (NFC, Qwen's
pattern, a template with a default system message in
``tokenizer_config.json``) and a GPT-2 one (``ByteLevel(use_regex=true)``,
added tokens with lstrip / rstrip / single_word / normalized, templates as a
named list, one calling ``raise_exception``). ``chip_smoke.py``'s Llama 3
tokenizer is held to the library too. ``encode``, ``decode`` and
``apply_chat_template`` must be equal on every hypothesis case: text over
``\\x1c``-``\\x1f``, no-break spaces, combining marks, CJK, emoji, digit runs,
upper-case contractions, the long s and the Kelvin sign and embedded special
tokens; id lists with partial UTF-8, ids past the vocab and special ids.

Three SentencePiece-style byte-fallback BPE tokenizers (Mistral's and
Mixtral's kind: ``<unk>``/``<s>``/``</s>``, the 256 ``<0xXX>`` pieces in the
vocab, merges trained on the README, ``LlamaTokenizer`` as the class) are
held to the library the same way, with leading, repeated and trailing
spaces, CJK and emoji among the pieces: the legacy form (``Prepend`` /
``Replace`` normalizers, no pre-tokenizer, the ``Replace`` /
``ByteFallback`` / ``Fuse`` / ``Strip`` decoder, Mixtral's chat template),
the form transformers converts to now (a ``Metaspace`` pre-tokenizer that
prepends to the first piece only) and one with ``Metaspace`` as
pre-tokenizer and decoder, plus ``chip_smoke.py``'s Mixtral tokenizer.

WordPiece and Unigram tokenizers, trained with the library on the README and
a fixed multilingual corpus, are held to it on encode and decode: BERT's
(``BertNormalizer``, ``BertPreTokenizer``, ``BertProcessing``, the
``WordPiece`` decoder), a cased one over ``Whitespace`` + ``Punctuation``
and ``TemplateProcessing``, T5's (``Nmt`` / ``NFKC`` / ``Replace`` /
``Strip`` / ``Lowercase`` normalizers, ``Metaspace``, ``</s>`` appended) and
a byte-fallback Unigram over ``WhitespaceSplit``. Their random strings are
drawn from the code points Unicode 3.2 already assigned; BERT's
punctuation, mark, dropped and case classes are the library's
(``utils/bert_chars.py``, written by ``scripts/gen_bert_char_classes.py``),
held to it on one probe string of every code point, and one character
assigned since Unicode 12 encodes as the library encodes it
(``test_characters_newer_than_the_librarys_unicode_tables_part``).
What the reader lacks (the ``Precompiled`` normalizer, other models,
normalizers, pre-tokenizers, post-processors and decoders) is refused by
name."""

import json

import pytest

pytest.importorskip("torch")
tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from tokenizers import (  # noqa: E402
    AddedToken,
    Regex,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    processors,
    trainers,
)

import chip_smoke  # noqa: E402
from distributed_gpu_inference_torch.utils import hf_tokenizer  # noqa: E402
from distributed_gpu_inference_torch.utils.hf_tokenizer import (  # noqa: E402
    HFTokenizer,
    TokenizerUnsupported,
    translate_pattern,
)
from distributed_gpu_inference_torch.worker.engines.base import EngineLoadError  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402

README = (chip_smoke.__file__.rsplit("/", 1)[0] + "/README.md")
LLAMA3_SPLIT = chip_smoke.LLAMA3_SPLIT
QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
              r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_TEMPLATE = chip_smoke.LLAMA3_TEMPLATE
QWEN_TEMPLATE = (
    "{%- if messages[0]['role'] == 'system' %}"
    "{{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}"
    "{%- else %}"
    "{{- '<|im_start|>system\\nYou are a helpful assistant.<|im_end|>\\n' }}"
    "{%- endif %}"
    "{%- for message in messages %}"
    "{%- if not (loop.first and message['role'] == 'system') %}"
    "{{- '<|im_start|>' + message['role'] + '\\n' + message['content'] + '<|im_end|>\\n' }}"
    "{%- endif %}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}{{- '<|im_start|>assistant\\n' }}{%- endif %}")
GPT2_TEMPLATE = (
    "{% for m in messages %}"
    "{% if m['role'] not in ['user', 'assistant'] %}"
    "{{ raise_exception('Conversation roles must be user or assistant, not ' + m['role']) }}"
    "{% endif %}"
    "{{ m['role'] | upper }}: {{ m['content'] }}{{ eos_token }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}ASSISTANT:{% endif %}")
GPT2_TOOLS_TEMPLATE = "{{ messages | tojson }}|{{ strftime_now('%Y') | length }}"


def _train(pre, size, normalizer=None, ignore_merges=False):
    tok = Tokenizer(models.BPE(ignore_merges=ignore_merges))
    if normalizer is not None:
        tok.normalizer = normalizer
    tok.pre_tokenizer = pre
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator([open(README, encoding="utf-8").read()], trainers.BpeTrainer(
        vocab_size=size, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    return tok


def _save(tok, d, **config):
    from transformers import PreTrainedTokenizerFast

    template = config.pop("chat_template", None)
    hf = PreTrainedTokenizerFast(tokenizer_object=tok, **config)
    if isinstance(template, str):
        hf.chat_template = template        # saved to chat_template.jinja
    hf.save_pretrained(str(d))
    if template is not None and not isinstance(template, str):
        cfg_path = d / "tokenizer_config.json"
        cfg = json.loads(cfg_path.read_text())
        cfg["chat_template"] = template    # older checkpoints keep it here
        cfg_path.write_text(json.dumps(cfg))
    return d


def build_llama3(d):
    tok = _train(pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]), 480,
        ignore_merges=True)
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in (
        "<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>", "<|end_header_id|>",
        "<|eot_id|>")])
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(single="<|begin_of_text|> $A",
                                      pair="<|begin_of_text|> $A <|begin_of_text|> $B",
                                      special_tokens=[("<|begin_of_text|>", 480)])])
    return _save(tok, d, bos_token="<|begin_of_text|>", eos_token="<|eot_id|>",
                 clean_up_tokenization_spaces=True, chat_template=LLAMA3_TEMPLATE)


def build_qwen(d):
    tok = _train(pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN_SPLIT), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]), 500,
        normalizer=normalizers.NFC())
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in (
        "<|endoftext|>", "<|im_start|>", "<|im_end|>")])
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    d = _save(tok, d, eos_token="<|im_end|>", pad_token="<|endoftext|>",
              clean_up_tokenization_spaces=False, chat_template=None)
    cfg_path = d / "tokenizer_config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["chat_template"] = QWEN_TEMPLATE
    cfg_path.write_text(json.dumps(cfg))
    return d


def build_gpt2(d):
    tok = _train(pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True), 450)
    tok.add_special_tokens([AddedToken("<|endoftext|>", special=True, normalized=False),
                            AddedToken("<mask>", special=True, lstrip=True, normalized=False)])
    tok.add_tokens([AddedToken("[SEP]", rstrip=True, normalized=False),
                    AddedToken("hello world", single_word=True, normalized=True)])
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    return _save(tok, d, eos_token="<|endoftext|>", bos_token="<|endoftext|>",
                 add_prefix_space=True, chat_template=[
                     {"name": "default", "template": GPT2_TEMPLATE},
                     {"name": "tool_use", "template": GPT2_TOOLS_TEMPLATE}])


SP = "\u2581"
MIXTRAL_TEMPLATE = chip_smoke.MIXTRAL_TEMPLATE


def build_sentencepiece(d, form):
    """A Mistral-style byte-fallback BPE in ``form`` ("legacy", "first" or
    "metaspace"). The library's trainer would make the ``<0xXX>`` pieces
    added tokens, so the vocab is laid out by hand: the specials at 0-2,
    the byte pieces at 3-258, then the trained pieces and their merges."""
    trained = Tokenizer(models.BPE(unk_token="<unk>"))
    trained.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="always", split=True)
    trained.train_from_iterator([open(README, encoding="utf-8").read()], trainers.BpeTrainer(
        vocab_size=700, special_tokens=["<unk>", "<s>", "</s>"], show_progress=False))
    spec = json.loads(trained.to_str())["model"]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    for t, _ in sorted(spec["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(t, len(vocab))
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[tuple(m) for m in spec["merges"]],
                               unk_token="<unk>", fuse_unk=True, byte_fallback=True))
    tok.add_special_tokens(["<unk>", "<s>", "</s>"])
    chain = decoders.Sequence([decoders.Replace(SP, " "), decoders.ByteFallback(),
                               decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    if form == "legacy":
        tok.normalizer = normalizers.Sequence([normalizers.Prepend(SP),
                                               normalizers.Replace(" ", SP)])
        tok.decoder = chain
    elif form == "first":
        tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first", split=False)
        tok.decoder = chain
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="always", split=True)
        tok.decoder = decoders.Sequence([decoders.ByteFallback(), decoders.Metaspace(
            prepend_scheme="always", split=True)])
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", pair="<s> $A <s> $B", special_tokens=[("<s>", 1)])
    d.mkdir(parents=True)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
        "unk_token": "<unk>", "add_bos_token": True, "add_eos_token": False,
        "legacy": form == "legacy", "clean_up_tokenization_spaces": False,
        "chat_template": MIXTRAL_TEMPLATE}))
    return d


BUILDERS = {"llama3": build_llama3, "qwen": build_qwen, "gpt2": build_gpt2,
            "mistral": lambda d: build_sentencepiece(d, "legacy"),
            "mistral-first": lambda d: build_sentencepiece(d, "first"),
            "metaspace": lambda d: build_sentencepiece(d, "metaspace")}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """{kind: (transformers tokenizer, the port's)} over one directory each,
    and chip_smoke.py's Llama 3 tokenizer."""
    from transformers import AutoTokenizer

    root = tmp_path_factory.mktemp("tokenizers")
    out = {}
    for kind, build in BUILDERS.items():
        d = build(root / kind)
        out[kind] = (AutoTokenizer.from_pretrained(str(d)), HFTokenizer.from_dir(d))
    smoke = root / "smoke"
    smoke.mkdir()
    chip_smoke.write_llama3_tokenizer(smoke, open(README, encoding="utf-8").read(), 300)
    out["smoke"] = (AutoTokenizer.from_pretrained(str(smoke)), HFTokenizer.from_dir(smoke))
    mixtral = root / "smoke-mixtral"
    mixtral.mkdir()
    chip_smoke.write_mixtral_tokenizer(mixtral, open(README, encoding="utf-8").read(), 300,
                                       vocab_size=1000)
    out["smoke-mixtral"] = (AutoTokenizer.from_pretrained(str(mixtral)),
                            HFTokenizer.from_dir(mixtral))
    return out


SP_KINDS = ["mistral", "mistral-first", "metaspace", "smoke-mixtral"]
KINDS = ["llama3", "qwen", "gpt2", "smoke"] + SP_KINDS

PIECES = ["\x1c", "\x1d", "\x1e", "\x1f", "\xa0", " ", "\u3000", "\u2009", "  ", "\t",
          "\n", "\r\n", "\n\n ", "\xe9", "e\u0301", "\u0308a", "\u4e2d", "\u6587\u5b57",
          "\ud55c\uad6d\uc5b4", "\U0001f600", "\U0001f44d\U0001f3fd",
          "\U0001f1fa\U0001f1f3", "0", "12", "345", "67890", "\u0661\u0662", "'S", "'LL",
          "'Ve", "'re", "'d", "\u017f", "'\u017f", "\u212a", "K", "<|eot_id|>",
          "<|begin_of_text|>", "<|im_end|>", "<|endoftext|>", "<mask>", " <mask>", "[SEP]",
          "[SEP]  x", "hello world", "xhello world", "hello worldx", "_hello world", "Hello",
          "world", "\xc9COLE", "na\xefve", "caf\xe9", ",", " .", " ,", " !", " ?", " n't",
          " 's", "' ", "...", "\u2014", "\xab\xbb", "#", "$", "\\", "_", "<s>", "</s>",
          "<unk>", " <s> ", "\u2581", "\u2581\u2581x", "<0x41>", "   "]

texts = st.one_of(
    st.lists(st.sampled_from(PIECES), max_size=24).map("".join),
    st.text(alphabet=st.characters(blacklist_categories=("Cs",), max_codepoint=0x1FFFF),
            max_size=40),
    st.lists(st.one_of(st.sampled_from(PIECES), st.text(max_size=3, alphabet=st.characters(
        blacklist_categories=("Cs",)))), max_size=16).map("".join))


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=150, deadline=None, derandomize=True)
@given(text=texts)
def test_encode_equals_transformers(pairs, kind, text):
    hf, ours = pairs[kind]
    assert ours.encode(text) == hf.encode(text)
    assert ours.encode(text, add_special_tokens=False) == hf.encode(text, add_special_tokens=False)


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=150, deadline=None, derandomize=True)
@given(data=st.data())
def test_decode_equals_transformers(pairs, kind, data):
    hf, ours = pairs[kind]
    top = len(hf) + 20 if kind != "smoke" else 128300
    specials = sorted(set(hf.all_special_ids) | set(ours.added_by_id))
    ids = data.draw(st.lists(st.one_of(
        st.integers(0, 255),                        # single bytes: partial UTF-8
        st.integers(0, top),                        # past the vocab too
        st.sampled_from(specials)), max_size=40))
    assert ours.decode(ids) == hf.decode(ids)


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_of_the_readme_and_the_attributes(pairs, kind):
    hf, ours = pairs[kind]
    text = open(README, encoding="utf-8").read()
    ids = ours.encode(text)
    assert ids == hf.encode(text)
    assert ours.decode(ids) == hf.decode(ids)
    assert (ours.eos_token_id, ours.bos_token_id, ours.vocab_size) == (
        hf.eos_token_id, hf.bos_token_id, hf.vocab_size)
    # multi-byte characters split across tokens decode to U+FFFD until
    # complete, as the library's decode does (the stream splicer's cue)
    cjk = ours.encode("東京", add_special_tokens=False)
    for n in range(len(cjk) + 1):
        assert ours.decode(cjk[:n]) == hf.decode(cjk[:n])


SP_TEXTS = ["Hello world", " Hello", "  Hello  world  ", "Hello ", "   ", " ", "",
            "\u6771\u4eac\u3067 \U0001f600 and \U0001f44d\U0001f3fd", "na\xefve caf\xe9",
            "<s>Hello</s> world", "a</s>b", "<s> <s>", "x <unk> y", "\u2581a\u2581 b",
            "tab\tand\nnewline\n", "<0x41> literal"]


@pytest.mark.parametrize("kind", SP_KINDS)
def test_sentencepiece_pieces_equal_transformers(pairs, kind):
    """Spaces (leading, repeated, trailing), byte-fallback pieces for CJK
    and emoji, the post-processor's ``<s>``, literal specials and decode
    with and without special tokens, on fixed texts and every README
    line."""
    hf, ours = pairs[kind]
    lines = open(README, encoding="utf-8").read().splitlines()
    for text in SP_TEXTS + lines:
        ids = ours.encode(text)
        assert ids == hf.encode(text), text
        assert ids[0] == ours.bos_token_id == 1
        plain = ours.encode(text, add_special_tokens=False)
        assert plain == hf.encode(text, add_special_tokens=False) == ids[1:]
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == \
                hf.decode(ids, skip_special_tokens=skip), (text, skip)
    emoji = ours.encode("\U0001f600", add_special_tokens=False)
    pieces = [ours.id_to_token[i] for i in emoji]
    assert pieces[-4:] == ["<0xF0>", "<0x9F>", "<0x98>", "<0x80>"]
    # a run of byte pieces cut short decodes to one U+FFFD a byte
    for n in range(len(emoji) + 1):
        assert ours.decode(emoji[:n]) == hf.decode(emoji[:n])


@pytest.mark.parametrize("kind", SP_KINDS)
@settings(max_examples=60, deadline=None, derandomize=True)
@given(data=st.data())
def test_sentencepiece_decode_without_specials_equals_transformers(pairs, kind, data):
    hf, ours = pairs[kind]
    ids = data.draw(st.lists(st.one_of(st.integers(0, 300), st.integers(0, len(hf) + 20),
                                       st.sampled_from([0, 1, 2])), max_size=40))
    assert ours.decode(ids, skip_special_tokens=True) == hf.decode(ids, skip_special_tokens=True)


@pytest.mark.parametrize("fuse", [True, False])
def test_unknown_characters_without_byte_pieces_equal_transformers(fuse):
    """A character outside the vocab whose bytes are not all ``<0xXX>``
    pieces becomes ``<unk>``, one for a run of them with ``fuse_unk``, and
    is placed after any byte pieces that follow it, as the library does."""
    vocab = {"<unk>": 0, SP: 1, "a": 2, "b": 3, "<0xC3>": 4, "<0xA9>": 5, SP + "a": 6}
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[(SP, "a")], unk_token="<unk>",
                               fuse_unk=fuse, byte_fallback=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend(SP),
                                           normalizers.Replace(" ", SP)])
    tok.decoder = decoders.ByteFallback()
    ours = HFTokenizer(json.loads(tok.to_str()))
    for text in ("a \u4e2d\u6587b", "\xe9x\xe9", "\xe9xx\xe9a", "ab", "zz a", "x"):
        assert ours.encode(text) == tok.encode(text).ids, text


def test_a_long_sentencepiece_section_merges_in_one_pass(pairs):
    """With no pre-tokenizer a whole section is one BPE word: the README
    as one line encodes as the library encodes it."""
    hf, ours = pairs["mistral"]
    text = " ".join(open(README, encoding="utf-8").read().split())
    assert ours.encode(text) == hf.encode(text)


MESSAGES = [
    [{"role": "user", "content": "Hello there"}],
    [{"role": "system", "content": "  Be brief.  "}, {"role": "user", "content": "2+2?"},
     {"role": "assistant", "content": "4"}, {"role": "user", "content": "Grüße 東京 😀"}],
    [{"role": "assistant", "content": "<|eot_id|> <mask>"}, {"role": "user", "content": ""}],
]


@pytest.mark.parametrize("gen", [True, False])
@pytest.mark.parametrize("conv", range(len(MESSAGES)))
@pytest.mark.parametrize("kind", KINDS)
def test_chat_template_equals_transformers(pairs, kind, conv, gen):
    import jinja2

    hf, ours = pairs[kind]
    msgs = MESSAGES[conv]
    try:
        want = hf.apply_chat_template(msgs, tokenize=False, add_generation_prompt=gen)
    except jinja2.exceptions.TemplateError as exc:     # the gpt2 template's refusal
        with pytest.raises(jinja2.exceptions.TemplateError, match=str(exc)):
            ours.apply_chat_template(msgs, tokenize=False, add_generation_prompt=gen)
        return
    assert ours.apply_chat_template(msgs, tokenize=False, add_generation_prompt=gen) == want
    assert ours.apply_chat_template(msgs, tokenize=True, add_generation_prompt=gen) == \
        hf.apply_chat_template(msgs, tokenize=True, add_generation_prompt=gen)


def test_qwen_template_adds_its_default_system_message(pairs):
    hf, ours = pairs["qwen"]
    text = ours.apply_chat_template([{"role": "user", "content": "hi"}],
                                    add_generation_prompt=True)
    assert text.startswith("<|im_start|>system\nYou are a helpful assistant.<|im_end|>")
    assert text == hf.apply_chat_template([{"role": "user", "content": "hi"}],
                                          tokenize=False, add_generation_prompt=True)


def test_raise_exception_in_a_template_raises_as_in_transformers(pairs):
    import jinja2

    hf, ours = pairs["gpt2"]
    msgs = [{"role": "system", "content": "x"}]
    with pytest.raises(jinja2.exceptions.TemplateError) as want:
        hf.apply_chat_template(msgs, tokenize=False)
    with pytest.raises(jinja2.exceptions.TemplateError) as got:
        ours.apply_chat_template(msgs)
    assert str(got.value) == str(want.value) == \
        "Conversation roles must be user or assistant, not system"
    # a named list: transformers takes its "default" entry
    assert set(ours.chat_template) == {"default", "tool_use"}


def test_a_tokenizer_without_a_template_raises_instead_of_joining(tmp_path):
    from transformers import AutoTokenizer

    d = build_llama3(tmp_path / "t")
    (d / "chat_template.jinja").unlink()
    hf, ours = AutoTokenizer.from_pretrained(str(d)), HFTokenizer.from_dir(d)
    msgs = [{"role": "user", "content": "hi"}]
    with pytest.raises(ValueError, match="chat_template is not set"):
        hf.apply_chat_template(msgs, tokenize=False)
    with pytest.raises(ValueError, match="chat_template is not set"):
        ours.apply_chat_template(msgs)


def test_the_gpt2_pattern_translates_whitespace_as_oniguruma():
    import re

    rx = re.compile(translate_pattern(r"\s+|\S+"))
    # \x1c-\x1f are not White_Space: they stay with the word
    assert rx.findall("a\x1cb c\xa0d") == ["a\x1cb", " ", "c", "\xa0", "d"]
    assert re.fullmatch(translate_pattern(r"[^\s\p{L}\p{N}]+"), "\x1c\x1f#")
    assert re.fullmatch(translate_pattern(r"\p{N}{1,3}"), "١٢٣")          # Arabic-Indic digits
    assert re.fullmatch(translate_pattern(r"(?i:'s)"), "'ſ")


def _sentencepiece_like(kind):
    """tokenizer.json specs the reader refuses, each naming its piece (the
    pieces it reads beside them)."""
    base = Tokenizer(models.BPE(vocab={"a": 0, "b": 1, "ab": 2}, merges=[("a", "b")]))
    base.decoder = decoders.ByteLevel()
    if kind == "lowercase":
        base.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                                normalizers.Lowercase(),
                                                normalizers.StripAccents()])
    elif kind == "whitespace":
        base.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.Metaspace(),
                                                      pre_tokenizers.Whitespace(),
                                                      pre_tokenizers.Digits()])
    elif kind == "ctc":
        base.decoder = decoders.Sequence([decoders.ByteFallback(), decoders.CTC()])
    elif kind == "unigram":
        # a converted spiece.model's charsmap; the library builds one only
        # from a SentencePiece model file, so the spec is written by hand
        base = Tokenizer(models.Unigram([("a", -1.0), ("b", -2.0)], 0, byte_fallback=False))
        base.decoder = decoders.Metaspace()
        spec = json.loads(base.to_str())
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": "AAAA"},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}
        return spec
    elif kind == "wordpiece":
        base = Tokenizer(models.WordPiece({"[UNK]": 0, "a": 1, "<s>": 2, "</s>": 3},
                                          unk_token="[UNK]"))
        base.decoder = decoders.WordPiece()
        base.post_processor = processors.RobertaProcessing(("</s>", 3), ("<s>", 2))
    return json.loads(base.to_str())


@pytest.mark.parametrize("kind,match", [
    ("lowercase", "normalizer 'StripAccents'"),
    ("whitespace", "pre-tokenizer 'Digits'"),
    ("ctc", "decoder 'CTC'"),
    ("unigram", "normalizer 'Precompiled'"),
    ("wordpiece", "post-processor 'RobertaProcessing'"),
])
def test_sentencepiece_style_tokenizers_are_refused_naming_the_piece(tmp_path, kind, match):
    spec = _sentencepiece_like(kind)
    with pytest.raises(TokenizerUnsupported, match=match):
        HFTokenizer(spec)
    d = tmp_path / kind
    d.mkdir()
    (d / "tokenizer.json").write_text(json.dumps(spec))
    llm = TorchLLMEngine({"model": "llama3-tiny", "device": "cpu", "tokenizer_id": str(d)})
    with pytest.raises(EngineLoadError, match=f"tokenizer_id.*{match}"):
        llm.load_model()
    assert llm.engine is None


def test_added_token_ids_the_library_would_renumber_are_refused(tmp_path):
    spec = json.loads((build_llama3(tmp_path / "t") / "tokenizer.json").read_text())
    spec["added_tokens"][1]["id"] = 128001      # a gap after the vocab
    with pytest.raises(ValueError, match="has id 128001"):
        HFTokenizer(spec)


def test_a_template_needs_jinja2_at_load(tmp_path, monkeypatch):
    import sys

    from distributed_gpu_inference_torch.utils import hf_tokenizer

    d = build_llama3(tmp_path / "t")
    hf_tokenizer._jinja.cache_clear()
    monkeypatch.setitem(sys.modules, "jinja2", None)      # import jinja2 → ImportError
    try:
        llm = TorchLLMEngine({"model": "llama3-tiny", "device": "cpu",
                              "tokenizer_id": str(d)})
        with pytest.raises(EngineLoadError, match="jinja2"):
            llm.load_model()
    finally:
        hf_tokenizer._jinja.cache_clear()


# ---------------------------------------------------------------- WordPiece and Unigram

MULTILINGUAL = [
    "The quick brown fox jumps over the lazy dog.", "Don't stop: it's 3.14, $5 (or 5%)!",
    "Größe, Straße und naïve Façade — déjà vu.", "Ελληνικά: ΟΔΟΣ οδός ῥυθμός", "Привет, мир!",
    "東京で日本語と中文字を書く。", "한국어 텍스트", "हिन्दी पाठ", "العربية نص", "עברית",
    "ﬁne ﬂow ½ ² Ⅻ ｆｕｌｌ", "  leading and  double  spaces ", "tabs\tand\nnew\r\nlines",
    "CamelCase snake_case kebab-case", "e\u0301 \u0308a", "\x00nul\x07bell\u200bzero\ufffd",
    "emoji 😀👍🏽 🇺🇳", "[CLS] [MASK] [SEP] </s> <pad> <unk>", "UPPER lower MiXeD", "",
]


def _corpus():
    return [open(README, encoding="utf-8").read()] + MULTILINGUAL * 3


def build_bert(d, size=900):
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]", max_input_chars_per_word=24))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.train_from_iterator(_corpus(), trainers.WordPieceTrainer(
        vocab_size=size, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"],
        show_progress=False))
    tok.post_processor = processors.BertProcessing(("[SEP]", tok.token_to_id("[SEP]")),
                                                   ("[CLS]", tok.token_to_id("[CLS]")))
    tok.decoder = decoders.WordPiece()
    return _save(tok, d, unk_token="[UNK]", sep_token="[SEP]", pad_token="[PAD]",
                 cls_token="[CLS]", mask_token="[MASK]", clean_up_tokenization_spaces=True)


def build_bert_cased(d):
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=False, strip_accents=True,
                                                handle_chinese_chars=False, clean_text=True)
    tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.Whitespace(),
                                                 pre_tokenizers.Punctuation()])
    tok.train_from_iterator(_corpus(), trainers.WordPieceTrainer(
        vocab_size=700, special_tokens=["[UNK]", "[CLS]", "[SEP]"], show_progress=False))
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", 1), ("[SEP]", 2)])
    tok.decoder = decoders.WordPiece(prefix="##", cleanup=False)
    return _save(tok, d, unk_token="[UNK]", cls_token="[CLS]", sep_token="[SEP]",
                 clean_up_tokenization_spaces=False)


def build_t5(d):
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.Sequence([
        normalizers.Nmt(), normalizers.NFKC(), normalizers.Replace(Regex(" {2,}"), " "),
        normalizers.Strip(left=False, right=True), normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement=SP, prepend_scheme="always")
    tok.train_from_iterator(_corpus(), trainers.UnigramTrainer(
        vocab_size=700, special_tokens=["<pad>", "</s>", "<unk>"], unk_token="<unk>",
        show_progress=False))
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>", special_tokens=[("</s>", 1)])
    tok.decoder = decoders.Metaspace(replacement=SP, prepend_scheme="always")
    return _save(tok, d, eos_token="</s>", unk_token="<unk>", pad_token="<pad>")


def build_unigram_bytes(d):
    """A byte-fallback Unigram: the trainer's pieces plus the 256
    ``<0xXX>`` pieces, scored below every trained one."""
    trained = Tokenizer(models.Unigram())
    trained.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    trained.train_from_iterator(_corpus(), trainers.UnigramTrainer(
        vocab_size=500, special_tokens=["<unk>", "<s>", "</s>"], unk_token="<unk>",
        show_progress=False))
    vocab = json.loads(trained.to_str())["model"]["vocab"]
    low = min(sc for _, sc in vocab) - 1.0
    have = {t for t, _ in vocab}
    vocab += [[f"<0x{b:02X}>", low] for b in range(256) if f"<0x{b:02X}>" not in have]
    tok = Tokenizer(models.Unigram([tuple(v) for v in vocab], 0, byte_fallback=True))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.decoder = decoders.Sequence([decoders.ByteFallback(), decoders.Fuse()])
    tok.add_special_tokens(["<unk>", "<s>", "</s>"])
    return _save(tok, d, unk_token="<unk>", bos_token="<s>", eos_token="</s>")


MODEL_BUILDERS = {"bert": build_bert, "bert-cased": build_bert_cased, "t5": build_t5,
                  "unigram-bytes": build_unigram_bytes}
MODEL_KINDS = list(MODEL_BUILDERS)


@pytest.fixture(scope="module")
def model_pairs(tmp_path_factory):
    from transformers import AutoTokenizer

    root = tmp_path_factory.mktemp("models")
    out = {}
    for kind, build in MODEL_BUILDERS.items():
        d = build(root / kind)
        out[kind] = (AutoTokenizer.from_pretrained(str(d)), HFTokenizer.from_dir(d))
    return out


def _assigned_in_unicode_3_2(c):
    import unicodedata

    return unicodedata.ucd_3_2_0.category(c) != "Cn"


OLD_PIECES = [p for p in PIECES + MULTILINGUAL if all(map(_assigned_in_unicode_3_2, p))]
old_texts = st.one_of(
    st.lists(st.sampled_from(OLD_PIECES), max_size=24).map("".join),
    st.text(alphabet=st.characters(blacklist_categories=("Cs",), max_codepoint=0x1FFFF)
            .filter(_assigned_in_unicode_3_2), max_size=40))


@pytest.mark.parametrize("kind", MODEL_KINDS)
def test_models_on_the_corpus_equal_transformers(model_pairs, kind):
    """Each corpus line, the README line by line and whole, and 200 seeded
    random strings: ids with and without the post-processor, and the
    decode of every id list with and without special tokens."""
    import random

    hf, ours = model_pairs[kind]
    rng = random.Random(16)
    alphabet = [c for c in map(chr, range(0x20, 0x3000)) if _assigned_in_unicode_3_2(c)]
    alphabet += [chr(c) for c in range(0x4E00, 0x4F00)] + ["😀", "👍", " ", "\t", "\n"]
    randoms = ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
               for _ in range(200)]
    readme = open(README, encoding="utf-8").read()
    for text in MULTILINGUAL + readme.splitlines() + [readme] + randoms:
        ids = ours.encode(text)
        assert ids == hf.encode(text), text
        assert ours.encode(text, add_special_tokens=False) == \
            hf.encode(text, add_special_tokens=False), text
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == \
                hf.decode(ids, skip_special_tokens=skip), (text, skip)
    assert (ours.eos_token_id, ours.bos_token_id, ours.vocab_size) == (
        hf.eos_token_id, hf.bos_token_id, hf.vocab_size)


@pytest.mark.parametrize("kind", MODEL_KINDS)
@settings(max_examples=120, deadline=None, derandomize=True)
@given(text=old_texts)
def test_models_encode_equals_transformers(model_pairs, kind, text):
    hf, ours = model_pairs[kind]
    assert ours.encode(text) == hf.encode(text)


@pytest.mark.parametrize("kind", MODEL_KINDS)
@settings(max_examples=120, deadline=None, derandomize=True)
@given(data=st.data())
def test_models_decode_equals_transformers(model_pairs, kind, data):
    hf, ours = model_pairs[kind]
    specials = sorted(set(hf.all_special_ids) | set(ours.added_by_id))
    ids = data.draw(st.lists(st.one_of(st.integers(0, len(hf) + 20),
                                       st.sampled_from(specials)), max_size=40))
    assert ours.decode(ids) == hf.decode(ids)
    assert ours.decode(ids, skip_special_tokens=True) == hf.decode(ids, skip_special_tokens=True)


def test_wordpiece_unknown_words_equal_transformers(model_pairs):
    """A word longer than ``max_input_chars_per_word``, or with a stretch no
    piece covers, is one ``[UNK]``; punctuation and CJK stand alone."""
    hf, ours = model_pairs["bert"]
    unk = ours.token_to_id("[UNK]")
    for text in ("x" * 25, "x" * 24, "a☃b", "中文字 ok", "Hello,world!", "don't"):
        assert ours.encode(text) == hf.encode(text), text
    assert ours.encode("x" * 25, add_special_tokens=False) == [unk]


def test_unigram_unknown_characters_fuse_or_fall_back_to_bytes(model_pairs):
    """Adjacent characters no piece starts with are one unknown stretch:
    ``<unk>`` in T5's kind, its bytes' ``<0xXX>`` pieces with
    ``byte_fallback``."""
    for kind in ("t5", "unigram-bytes"):
        hf, ours = model_pairs[kind]
        for text in ("☃☃ snow ☃", "🙂🙃x", "ab\u0378cd", "zzzz"):
            assert ours.encode(text) == hf.encode(text), (kind, text)
    hf, ours = model_pairs["unigram-bytes"]
    pieces = [ours.id_to_token[i] for i in ours.encode("☃", add_special_tokens=False)]
    assert pieces == ["<0xE2>", "<0x98>", "<0x83>"]


def test_characters_newer_than_the_librarys_unicode_tables_part(model_pairs):
    """U+0C77 (TELUGU SIGN SIDDHAM, punctuation since Unicode 12): the
    library's older tables keep it inside the word, one ``[UNK]`` for the
    word; the port's committed copy of those tables (``utils/bert_chars.py``,
    ROADMAP §3 item 8, repaired) keeps it there too, where the running
    Python's tables would make it a piece of its own."""
    hf, ours = model_pairs["bert"]
    text = "the\u0c77"
    assert ours.encode(text) == hf.encode(text)
    assert hf.encode(text)[1:-1] == [ours.token_to_id("[UNK]")]


def _every_code_point():
    """One probe string: every code point but the surrogates, each between
    two letters."""
    return "a" + "".join(chr(cp) + "a" for cp in range(0x110000)
                         if not 0xD800 <= cp < 0xE000)


@pytest.mark.parametrize("spec", [{"type": "BertPreTokenizer"},
                                  {"type": "Punctuation", "behavior": "Isolated"}],
                         ids=["bert", "punctuation"])
def test_bert_pre_tokenizers_equal_the_library_on_every_code_point(spec):
    """The port's BERT and Punctuation pre-tokenizers split a probe holding
    every code point as the library does: its punctuation class, read from
    the committed table, is the library's, not the running Python's."""
    lib = {"BertPreTokenizer": pre_tokenizers.BertPreTokenizer(),
           "Punctuation": pre_tokenizers.Punctuation("isolated")}[spec["type"]]
    probe = _every_code_point()
    pieces = [probe]
    for step in hf_tokenizer._pre_tokenizer(spec):
        pieces = [q for p in pieces for q in step(p, None)]
    assert pieces == [p for p, _ in lib.pre_tokenize_str(probe)]


@pytest.mark.parametrize("clean,strip,lower", [(True, False, False), (False, True, False),
                                               (False, False, True), (True, True, True)],
                         ids=["clean_text", "strip_accents", "lowercase", "all"])
def test_bert_normalizer_equals_the_library_on_every_code_point(clean, strip, lower):
    """``BertNormalizer`` over the same probe: ``clean_text``'s dropped
    classes, ``strip_accents``' nonspacing marks and decompositions and
    ``lowercase`` give the library's string."""
    probe = _every_code_point()
    kw = dict(clean_text=clean, handle_chinese_chars=False, strip_accents=strip,
              lowercase=lower)
    ours = hf_tokenizer._normalizer({"type": "BertNormalizer", **kw})(probe)
    assert ours == normalizers.BertNormalizer(**kw).normalize_str(probe)


def test_a_wordpiece_engine_loads_and_serves(tmp_path):
    """``TorchLLMEngine`` loads a WordPiece ``tokenizer_id`` and serves with
    it: the prompt encodes as transformers encodes it."""
    d = build_bert(tmp_path / "bert", size=480)       # within the tiny model's vocab
    llm = TorchLLMEngine({"model": "llama3-tiny", "device": "cpu", "dtype": "float32",
                          "tokenizer_id": str(d), "max_seq_len": 128,
                          "prefill_buckets": [16, 32, 64], "serving": {"mode": "direct"}})
    llm.load_model()
    try:
        from transformers import AutoTokenizer

        hf = AutoTokenizer.from_pretrained(str(d))
        assert llm.tokenizer.encode("Größe 東京!") == hf.encode("Größe 東京!")
        out = llm.inference({"prompt": "Hello, world", "max_new_tokens": 4, "ignore_eos": True})
        assert out["usage"]["completion_tokens"] == 4
    finally:
        llm.unload()
