"""Model assembly: stages -> init / train forward / prefill / decode.

Each stage is an nn.ModuleList of Blocks, one per layer, run by a Python
loop where the JAX package scans stacked parameters. Caches keep the JAX
package's layout, stacked over a stage's layers.

One switch, Model(trainable=...), sets the mode. A serving model (the
default) stores frozen parameters in their use dtype and its forward runs
under no_grad. A trainable model stores float32 masters that require grad
(layers.Params) and its forward builds a graph when grad is on, each block
under torch.utils.checkpoint (remat=True, the JAX package's jax.checkpoint
of the scanned layer body): a block's activations are recomputed in the
backward. Every family trains: the attention backward is the flash
backward kernel, the RG-LRU's the rg_lru backward kernel (kernels/ops.py);
MoE, xLSTM, the cross attention and the audio encoder are autograd over
plain tensor code.

Model(cfg, tp_size=M) picks the attention layout as the JAX package's
does: the flat layout, H padded to a multiple of M, when the KV heads do
not divide over M. Model(cfg, mesh=) builds a serving model of any
family on a ("data", "model") DeviceMesh of torch.distributed
(launch.mesh.make_mesh): each rank allocates only its shard of each
parameter and cache leaf (pshard.spec_for, runtime.sharding.
cache_shardings), takes its rows of the batch (and of the frontend), and
its layers issue the model axis's collectives (models/tp.py). The audio
encoder runs on the mesh too, its output whole over "model" on every
rank, as the frontend / enc_out caches are held.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import pshard
from repro_torch.device import resolve_device
from repro_torch.models import attention, blocks, recurrent, tp, xlstm
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    ParamDef,
    Params,
    embed_lookup,
    init_params,
    layer_norm,
    logits_out,
    pad_vocab,
    param_specs,
    rms_norm,
)


def _sinusoid(pos, d: int):
    """Whisper's sinusoidal position table at int positions (..., S):
    (..., S, d) in COMPUTE_DTYPE, sines then cosines, the frequencies
    exp(-i * (log(10000) / half)) in float32 as the JAX package builds them."""
    half = d // 2
    log_t = torch.log(torch.full((), 10000.0, dtype=torch.float32, device=pos.device))
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=pos.device)
                     * (log_t / half))
    ang = pos[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(COMPUTE_DTYPE)


class Block(nn.Module):
    """One layer of a stage: its parameters and its kind."""

    def __init__(self, cfg, spec: blocks.StageSpec, device, trainable: bool = False,
                 place=None):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.p = Params(blocks.block_defs(cfg, spec), device, trainable, place)

    def forward(self, x, aux: dict, cache=None):
        return blocks.block_apply(self.cfg, self.spec, self.p.tree(), x, aux, cache)


def _index(tree, i: int):
    return {k: _index(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def _write_layer(view, new, active, whole=None) -> None:
    """Write a layer's new cache into its views of the stacked cache; a
    leaf that already is its view (written in place) is left alone. With
    ``active`` (B,) bool, inactive slots keep their values; on a mesh whose
    batch is split, ``whole`` is the mask of the whole batch, which a leaf
    held whole on every rank (a KV cache's "len") takes."""
    if isinstance(view, dict):
        for k in view:
            _write_layer(view[k], new[k], active, whole)
        return
    if new is view:
        return
    if active is not None:
        if whole is not None and new.shape[0] != active.shape[0]:
            active = whole
        new = torch.where(active.view(-1, *[1] * (new.ndim - 1)), new, view)
    view.copy_(new)


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


TP_ITEM = ("TP / FSDP training, in the tensor-parallel half of ROADMAP.md section 1's "
           "sharding item (serving has the model axis)")


class Model(nn.Module):
    """The LM of one ArchConfig (any family) on one device. ``device=None``
    means the card and raises without CUDA; the parameters are allocated
    there uninitialised until init() or a load. ``moe_impl`` and
    ``moe_capacity`` reach every MoE block (the reference's defaults).

    ``trainable``: float32 master parameters that require grad, and a
    forward that builds a graph (every family). ``remat``: each block of a
    training forward under torch.utils.checkpoint.

    ``tp_size``: the attention layout for a model axis of that size (module
    docstring). ``mesh``: a DeviceMesh with named dims ("data", "model";
    "pod" too): this rank's shard of every leaf (tp_size is then the mesh's
    "model" size), its rows of a batch split over ("pod", "data"), and the
    "model" axis's collectives, through ``all_reduce`` when given
    (tp.TP)."""

    def __init__(self, cfg, device=None, moe_impl: str = "sorted",
                 moe_capacity: float = 1.25, trainable: bool = False, remat: bool = True,
                 tp_size: int | None = None, mesh=None, all_reduce=None):
        super().__init__()
        sizes = None if mesh is None else pshard.mesh_shape(mesh)
        if sizes is not None:
            m = sizes.get(tp.MODEL_AXIS, 1)
            if tp_size not in (None, m):
                raise ValueError(f"tp_size={tp_size} on a mesh whose model axis is {m}")
            tp_size = m
            if m > 1 and trainable:
                raise NotImplementedError(f"training on a model axis of {m} waits for "
                                          f"{TP_ITEM}")
        if tp_size and cfg.family != "ssm" and cfg.n_kv_heads % tp_size != 0:
            cfg = dataclasses.replace(cfg, attn_layout="flat",
                                      heads_padded=tp.flat_heads(cfg.n_heads, tp_size))
        self.cfg = cfg
        self.stages = blocks.stages_for(cfg)
        self.vocab_padded = pad_vocab(cfg.vocab_size)
        self.device = resolve_device(device)
        self.moe_impl = moe_impl
        self.moe_capacity = moe_capacity
        self.trainable = trainable
        self.remat = remat
        self.mesh = mesh
        self.place = None if mesh is None else tp.Placement.on(mesh)
        self.tp = (tp.TP.on_mesh(mesh, tp.widths(cfg, self.vocab_padded), all_reduce)
                   if sizes is not None and tp.MODEL_AXIS in sizes else None)
        if self.tp is not None and cfg.family == "ssm":
            self.tp.state_split = self._state_split()
        self.top = Params(self._top_defs(), self.device, trainable, self.place)
        self.stage_layers = nn.ModuleList(
            nn.ModuleList(Block(cfg, spec, self.device, trainable, self.place)
                          for _ in range(spec.n_layers))
            for spec in self.stages)

    # ---------------- params ----------------
    def _top_defs(self) -> dict:
        d, f32 = self.cfg.d_model, torch.float32
        audio = self.cfg.family == "audio"
        defs = {
            "embed": ParamDef((self.vocab_padded, d), ("vocab", "embed")),
            "unembed": ParamDef((self.vocab_padded, d), ("vocab", "embed")),
            "final_norm_w": ParamDef((d,), ("embed",), init="ones" if audio else "zeros",
                                     dtype=f32),
        }
        if audio:
            defs["final_norm_b"] = ParamDef((d,), ("embed",), init="zeros", dtype=f32)
        return defs

    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (on the model's device),
        layer by layer, in float32, stored in its storage dtype (float32
        masters when trainable)."""
        store = torch.float32 if self.trainable else None
        self.top.load_(init_params(self._top_defs(), generator, dtype=store))
        for layers in self.stage_layers:
            for blk in layers:
                blk.p.load_(init_params(blk.p.defs, generator, dtype=store))
        return self

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def param_tree(self) -> dict:
        """The parameters themselves as a tree: the top leaves, and "stages",
        a list (per stage) of lists (per layer) of each block's nested dict."""
        return {**self.top.tree(),
                "stages": [[blk.p.tree() for blk in layers] for layers in self.stage_layers]}

    def specs(self) -> dict:
        """The logical axes of every parameter, shaped as param_tree() (per
        layer: the reference's stacked leaves lead with "layers")."""
        return {**param_specs(self._top_defs()),
                "stages": [[param_specs(blk.p.defs) for blk in layers]
                           for layers in self.stage_layers]}

    def param_shapes(self) -> dict:
        """Every parameter whole (the flat layout's padded widths included),
        as meta tensors shaped as param_tree(): what tree_shardings resolves
        the specs against, whatever shard this rank holds."""
        def meta(defs):
            return {k: meta(d) if isinstance(d, dict)
                    else torch.empty(d.shape, dtype=d.dtype, device="meta")
                    for k, d in defs.items()}
        return {**meta(self._top_defs()),
                "stages": [[meta(blk.p.defs) for blk in layers] for layers in self.stage_layers]}

    @torch.no_grad()
    def load_params_(self, tree: dict, share: bool = False) -> "Model":
        """Copy a tree shaped as param_tree() into the parameters, in place;
        a leaf given whole is cut to this rank's shard (on a mesh), and a
        leaf that already is the parameter is left alone. With ``share``, a
        leaf that is this rank's shard in the parameter's dtype becomes the
        parameter (no copy); a model built on the meta device takes the
        shared tensors' device."""
        if len(tree["stages"]) != len(self.stage_layers):
            raise ValueError(f"{len(tree['stages'])} stages in the tree, "
                             f"{len(self.stage_layers)} in the model")
        self.top.load_({k: v for k, v in tree.items() if k != "stages"}, share)
        for layers, st in zip(self.stage_layers, tree["stages"]):
            for blk, leaves in zip(layers, st, strict=True):
                blk.p.load_(leaves, share)
        if self.device.type == "meta":
            self.device = next(self.parameters()).device
        return self

    # ---------------- stage runner ----------------
    def _run_stage(self, spec, layers, x, aux, cache_stacked):
        """Run one stage's layers in order. Returns (x, new stacked cache or
        None, aux_loss). With aux["in_place"] each layer's new cache is
        written into cache_stacked (only the slots of aux["active"], when
        given), which is returned: a compiled decode step's caches are its
        static buffers, and restacking them would copy every layer."""
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        in_place = aux.get("in_place", False) and cache_stacked is not None
        remat = self.remat and cache_stacked is None and torch.is_grad_enabled()
        new = []
        for i, blk in enumerate(layers):
            cache = None if cache_stacked is None else _index(cache_stacked, i)
            if remat:
                # the recompute in the backward gets this block's own aux,
                # marked once the forward has run
                blk_aux = dict(aux)
                x, new_cache, al = checkpoint(blk, x, blk_aux, None, use_reentrant=False,
                                              preserve_rng_state=False)
                blk_aux["recompute"] = True
            else:
                x, new_cache, al = blk(x, aux, cache)
            aux_sum = aux_sum + al
            if in_place:
                _write_layer(cache, new_cache, aux.get("active"), aux.get("active_whole"))
            else:
                new.append(new_cache)
        if cache_stacked is None or in_place:
            return x, cache_stacked, aux_sum
        return x, _stack(new), aux_sum

    # ---------------- forward paths ----------------
    def _final_norm(self, x):
        if self.cfg.family == "audio":
            return layer_norm(x, self.top.final_norm_w, self.top.final_norm_b,
                              self.cfg.norm_eps)
        return rms_norm(x, self.top.final_norm_w, self.cfg.norm_eps)

    def _positions(self, b: int, s: int):
        return torch.arange(s, dtype=torch.int32, device=self.device)[None].expand(b, s)

    def aux(self, positions, frontend=None, max_len: int | None = None) -> dict:
        """What every block gets beside its input: positions, the sequence
        the cross attention reads (or None), the MoE options, and on a model
        axis the tp.TP and the caches' max_len."""
        return {"pos": positions, "frontend": frontend, "moe_impl": self.moe_impl,
                "moe_capacity": self.moe_capacity, "tp": self.tp, "max_len": max_len}

    def _encode(self, frontend):
        """The audio encoder (stage 0) over frontend (B, F, D) plus the
        sinusoid table. Returns enc_out (B, F, D) (on a mesh: this rank's
        rows, whole over "model")."""
        b, f, _ = frontend.shape
        pos = self._positions(b, f)
        x = frontend.to(COMPUTE_DTYPE) + _sinusoid(pos, self.cfg.d_model)
        x, _, _ = self._run_stage(self.stages[0], self.stage_layers[0], x, self.aux(pos), None)
        return x

    def forward(self, tokens, frontend=None, caches=None, positions=None,
                last: bool = False, in_place: bool = False, active=None,
                return_hidden: bool = False, max_len: int | None = None):
        """tokens (B, S) int; frontend (B, Sf, D) or None: the audio
        encoder's input, or the image tokens a vlm cross-attends to. With
        caches and no frontend, the caches' enc_out / frontend stand in.
        Returns (logits float32 (B, S, Vp), new caches or None, aux loss);
        with ``last``, the logits of the last position only, (B, 1, Vp);
        with ``return_hidden``, the final-normed hidden states (B, S, D) in
        place of the logits. Builds a graph only for a trainable model with
        grad on.

        in_place / active (a compiled decode step, runtime/serve.py): the
        stage caches are written in place, only the active slots' when
        ``active`` is given, and the returned caches hold the same stage
        tensors.

        On a mesh: tokens are this rank's rows, the caches its shard,
        ``active`` the mask of the whole batch (held whole, as the
        reference's replicated operand) and ``max_len`` the caches' length
        (a flat-layout model's cache split reads it); the logits are this
        rank's rows, whole over the vocab."""
        with torch.set_grad_enabled(self.trainable and torch.is_grad_enabled()):
            return self._forward(tokens, frontend, caches, positions, last, in_place, active,
                                 return_hidden, max_len)

    def _forward(self, tokens, frontend, caches, positions, last, in_place, active,
                 return_hidden, max_len):
        b, s = tokens.shape
        if positions is None:
            positions = self._positions(b, s)
        x = embed_lookup(self.top.embed, tokens, self.cfg.vocab_size, self.tp)
        stages, stage_layers = self.stages, self.stage_layers
        stage_caches = caches["stages"] if caches is not None else [None] * len(stages)
        if self.cfg.family == "audio":
            x = x + _sinusoid(positions, self.cfg.d_model)
            if caches is not None and caches.get("enc_out") is not None and frontend is None:
                kv_src = caches["enc_out"]
            elif frontend is None:
                raise ValueError("an audio forward without caches needs a frontend "
                                 "(the encoder's input)")
            else:
                kv_src = self._encode(frontend)
                if caches is not None:
                    caches = dict(caches, enc_out=kv_src)
            # the encoder stage holds no cache slot
            stages, stage_layers, stage_caches = stages[1:], stage_layers[1:], stage_caches[1:]
        elif caches is not None and frontend is None:
            kv_src = caches.get("frontend")
        else:
            kv_src = None if frontend is None else frontend.to(COMPUTE_DTYPE)
            if caches is not None and kv_src is not None:
                caches = dict(caches, frontend=kv_src)
        aux = self.aux(positions, kv_src, max_len)
        if in_place:
            aux.update(in_place=True, active=None if active is None else self.local_rows(active),
                       active_whole=active)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_stage_caches = []
        for spec, layers, c_st in zip(stages, stage_layers, stage_caches):
            x, new_c, al = self._run_stage(spec, layers, x, aux, c_st)
            aux_total = aux_total + al
            new_stage_caches.append(new_c)
        if last:
            x = x[:, -1:]
        x = self._final_norm(x)
        logits = x if return_hidden else logits_out(x, self.top.unembed, self.cfg.vocab_size,
                                                    self.tp)
        new_caches = None
        if caches is not None:
            if self.cfg.family == "audio":
                new_stage_caches = [None] + new_stage_caches
            new_caches = dict(caches, stages=new_stage_caches, pos=caches["pos"] + s)
        return logits, new_caches, aux_total

    # ---------------- public APIs ----------------
    def train_logits(self, batch: dict):
        """The training forward of batch["tokens"] (and batch["frontend"]):
        (logits, caches None, aux loss)."""
        return self(batch["tokens"], batch.get("frontend"))

    def train_hidden(self, batch: dict):
        """Final-normed hidden states (B, S, D) and the aux loss, for the
        chunked cross-entropy (which never holds (B, S, V) logits)."""
        h, _, aux = self(batch["tokens"], batch.get("frontend"), return_hidden=True)
        return h, aux

    def prefill(self, batch: dict, max_len: int):
        """Run the prompt batch["tokens"] (B, S) (and batch["frontend"] when
        given) and fill fresh caches of max_len. Returns (last-position logits
        (B, Vp), caches)."""
        caches = self.make_caches(batch["tokens"].shape[0], max_len)
        logits, caches, _ = self(batch["tokens"], batch.get("frontend"), caches=caches,
                                 last=True, max_len=max_len)
        return logits[:, -1], caches

    def decode_step(self, caches: dict, token, in_place: bool = False, active=None,
                    max_len: int | None = None):
        """token: (B, 1). One step with the KV / state caches; functional
        unless ``in_place`` (forward). ``max_len``: the caches' length, which
        a flat-layout model on a model axis needs (forward)."""
        b = token.shape[0]
        pos = caches["pos"][:, None].expand(b, 1)
        logits, caches, _ = self(token, caches=caches, positions=pos, in_place=in_place,
                                 active=active, max_len=max_len)
        return logits[:, -1], caches

    # ---------------- caches ----------------
    def make_caches(self, batch: int, max_len: int) -> dict:
        """Zeroed caches for ``batch`` requests of up to max_len tokens: one
        entry a stage (None for the cross and encoder stages), "pos", and
        the zero "enc_out" (audio) or "frontend" (vlm) that a forward with
        caches and no frontend reads. On a mesh, ``batch`` is this rank's
        rows and each leaf is this rank's shard (cache_shardings)."""
        if self.place is None:
            return self._make_caches(batch, max_len, self.device)
        from repro_torch.runtime import sharding   # deferred: runtime imports models
        whole = self.cache_shapes(batch, max_len)
        return sharding.map_shardings(
            lambda sh, leaf, key: torch.full(
                pshard.local_shape(tuple(leaf.shape), sh.spec, self.place.sizes),
                _cache_fill(key, leaf), dtype=leaf.dtype, device=self.device),
            sharding.cache_shardings(self.place.sizes, whole, self.cfg), whole,
            _keys(whole))

    def _state_split(self) -> dict:
        """Each xLSTM state leaf's key -> whether cache_shardings places its
        last dim (hd) on "model" (the layout xlstm's _heads_in reads)."""
        from repro_torch.runtime import sharding   # deferred: runtime imports models
        rows = pshard.axis_size(self.place.sizes, ("pod", "data"))
        states = xlstm.make_xlstm_state(self.cfg, rows, 1, 1, "meta")
        placed = sharding.cache_shardings(self.place.sizes, states, self.cfg)
        return {key: sh.spec[-1] == tp.MODEL_AXIS
                for leaves in placed.values() for key, sh in leaves.items()}

    def local_rows(self, x):
        """This rank's rows of a tensor over the mesh's whole batch (the
        batch split over ("pod", "data"), as batch_spec places it); the
        tensor itself off a mesh or when the batch is not split."""
        sizes = self.place.sizes if self.place is not None else {}
        dp = tuple(a for a in ("pod", "data") if a in sizes)
        if not dp or pshard.axis_size(sizes, dp) == 1:
            return x
        return x[pshard.local_slice((x.shape[0],), (dp,), sizes, self.place.coord)]

    def cache_shapes(self, batch: int, max_len: int) -> dict:
        """The whole caches of the mesh's batch (``batch`` rows on each of
        its ("pod", "data") ranks) as meta tensors: what cache_shardings
        resolves, whatever shard this rank holds."""
        sizes = self.place.sizes if self.place is not None else {}
        return self._make_caches(batch * pshard.axis_size(sizes, ("pod", "data")), max_len,
                                 "meta")

    def local_caches(self, whole: dict) -> dict:
        """This rank's shard of a whole cache tree (tensors or numpy arrays)
        of the mesh's batch; the tree itself off a mesh."""
        if self.place is None:
            return whole
        from repro_torch.runtime import sharding   # deferred: runtime imports models
        shardings = sharding.cache_shardings(self.place.sizes, whole, self.cfg)
        return sharding.map_shardings(
            lambda sh, leaf: leaf[pshard.local_slice(tuple(leaf.shape), sh.spec, self.place.sizes,
                                                 self.place.coord)], shardings, whole)

    def _make_caches(self, batch: int, max_len: int, device) -> dict:
        stage_caches: list = []
        for spec in self.stages:
            if spec.cache is None:
                stage_caches.append(None)
            elif spec.cache == "kv":
                stage_caches.append({"kv": attention.make_cache(
                    self.cfg, batch, max_len, spec.n_layers, spec.window, device)})
            elif spec.cache == "rglru":
                stage_caches.append({"rglru": recurrent.make_rglru_state(
                    self.cfg, batch, spec.n_layers, device)})
            else:       # mlstm | slstm
                n_m, n_s = (spec.n_layers, 0) if spec.cache == "mlstm" else (0, spec.n_layers)
                st = xlstm.make_xlstm_state(self.cfg, batch, n_m, n_s, device)
                stage_caches.append({spec.cache: st[spec.cache]})
        out = {"stages": stage_caches,
               "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
        key = {"audio": "enc_out", "vlm": "frontend"}.get(self.cfg.family)
        if key is not None:
            out[key] = torch.zeros((batch, self.cfg.frontend_tokens, self.cfg.d_model),
                                   dtype=COMPUTE_DTYPE, device=device)
        return out


def _cache_fill(key: str, leaf) -> float:
    """The value _make_caches fills a cache leaf with: -1 in a KV cache's
    slot positions (empty slots), -1e30 in an sLSTM's stabiliser m
    (xlstm.make_xlstm_state), 0 elsewhere."""
    if key == "pos" and leaf.ndim == 3:
        return -1
    return -1e30 if key == "m" else 0


def _keys(tree, key: str = ""):
    """The tree with each leaf replaced by the dict key it sits under."""
    if isinstance(tree, dict):
        return {k: _keys(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v, key) for v in tree]
    return None if tree is None else key
