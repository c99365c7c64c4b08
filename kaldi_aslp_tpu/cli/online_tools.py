"""Online serving CLI mains.

JAX-native equivalents of the reference server/client binaries
(reference: src/aslp-onlinebin/aslp-online-nnet-vad-server.cc:33-130,
aslp-online-energy-vad-server.cc, aslp-audio-provider-client.cc).
The socket protocol is the framework's own (int16-LE PCM in, one JSON
object per line out — online/server.py), replacing the reference's
length-prefixed WavProvider protocol."""

from __future__ import annotations

import asyncio
import dataclasses
import json
import sys

import numpy as np

from kaldi_aslp_tpu.utils.config import Config, parse_options
from kaldi_aslp_tpu.utils.log import get_logger

logger = get_logger("online-cli")


@dataclasses.dataclass
class ServerFlags(Config):
    port: int = 5010
    feature_type: str = "fbank"
    num_mel_bins: int = 23
    chunk_frames: int = 16
    acoustic_scale: float = 1.0
    class_frame_counts: str = ""   # pdf prior counts file (optional)
    no_softmax: bool = False
    vad_nnet: str = ""             # VAD nnet model (nnet server)
    sil_threshold: float = 0.5
    energy_threshold: float = 9.0


def _build_session_factory(flags: ServerFlags, args, use_energy_vad: bool):
    import jax

    from kaldi_aslp_tpu.decoder import PackedGraph
    from kaldi_aslp_tpu.decoder.decodable import (
        NnetForwardOptions,
        PdfPrior,
        nnet_forward,
    )
    from kaldi_aslp_tpu.decoder.online import OnlineViterbiDecoder
    from kaldi_aslp_tpu.fst.fst import Fst, SymbolTable
    from kaldi_aslp_tpu.models import Nnet
    from kaldi_aslp_tpu.online.feature_pipeline import (
        OnlineFeatureOptions,
        OnlineFeaturePipeline,
    )
    from kaldi_aslp_tpu.online.server import DecodeSession
    from kaldi_aslp_tpu.online.vad_pipeline import OnlineVadFeaturePipeline
    from kaldi_aslp_tpu.online.vad_session import VadDecodeSession
    from kaldi_aslp_tpu.vad import EnergyVad, NnetVad, VadOptions

    net, params, _ = Nnet.load(args[0])
    lut = np.loadtxt(args[1], dtype=np.int64).reshape(-1)
    with open(args[2]) as f:
        packed = PackedGraph.from_fst(Fst.from_text(f.read()))
    with open(args[3]) as f:
        words = SymbolTable.from_text(f.read())
    prior = None
    if flags.class_frame_counts:
        counts = np.loadtxt(flags.class_frame_counts).reshape(-1)
        prior = PdfPrior(counts)
    fopts = NnetForwardOptions(
        acoustic_scale=1.0, no_softmax=flags.no_softmax,
    )

    def acoustic_fn(frames):
        return flags.acoustic_scale * nnet_forward(
            net, params, np.asarray(frames, np.float32), fopts,
            prior=prior,
        )

    feat_opts = OnlineFeatureOptions(
        feature_type=flags.feature_type,
        num_mel_bins=flags.num_mel_bins,
    )

    vad_net_params = None
    if flags.vad_nnet:
        vad_net_params = Nnet.load(flags.vad_nnet)[:2]

    def make_session():
        decoder = OnlineViterbiDecoder(packed, lut, acoustic_scale=1.0)
        if use_energy_vad:
            vad = EnergyVad(VadOptions(
                energy_threshold=flags.energy_threshold))
            pipeline = OnlineVadFeaturePipeline(feat_opts, vad=vad)
            return VadDecodeSession(pipeline, decoder, acoustic_fn,
                                    words, chunk_frames=flags.chunk_frames)
        if vad_net_params is not None:
            vnet, vparams = vad_net_params

            class _NnetFrameVad(NnetVad):
                """Per-chunk NN VAD: sil posterior at output 0
                (reference: aslp-vad/nnet-vad.cc:9-69)."""

                def is_speech_frame(self, frame):
                    y, _ = vnet.apply(
                        vparams,
                        np.asarray(frame, np.float32)[None, None, :])
                    post = np.asarray(jax.nn.softmax(y[0, 0]))
                    return post[0] < flags.sil_threshold

            pipeline = OnlineVadFeaturePipeline(
                feat_opts, vad=_NnetFrameVad(VadOptions()))
            return VadDecodeSession(pipeline, decoder, acoustic_fn,
                                    words, chunk_frames=flags.chunk_frames)
        # no VAD: endpoint-rule session
        return DecodeSession(
            OnlineFeaturePipeline(feat_opts), decoder, acoustic_fn,
            words, chunk_frames=flags.chunk_frames,
        )

    return make_session


def _serve(flags: ServerFlags, make_session) -> int:
    from kaldi_aslp_tpu.online.server import (
        OnlineServerOptions,
        OnlineTcpServer,
    )

    async def run():
        server = OnlineTcpServer(
            make_session,
            OnlineServerOptions(port=flags.port,
                                chunk_frames=flags.chunk_frames),
        )
        port = await server.start()
        print(f"listening on port {port}", flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


def online_nnet_vad_server(argv):
    """NN-decode server with (optional) NN VAD gating (reference:
    aslp-onlinebin/aslp-online-nnet-vad-server.cc)."""
    flags = ServerFlags()
    args = parse_options(
        argv, [flags],
        "aslp-online-nnet-vad-server [--vad-nnet=m] nnet-model "
        "tid2pdf.txt HCLG.txt words.txt",
        4, 4,
    )
    return _serve(flags,
                  _build_session_factory(flags, args, use_energy_vad=False))


def online_energy_vad_server(argv):
    """NN-decode server with energy-VAD gating (reference:
    aslp-onlinebin/aslp-online-energy-vad-server.cc)."""
    flags = ServerFlags()
    args = parse_options(
        argv, [flags],
        "aslp-online-energy-vad-server nnet-model tid2pdf.txt HCLG.txt "
        "words.txt",
        4, 4,
    )
    return _serve(flags,
                  _build_session_factory(flags, args, use_energy_vad=True))


def audio_provider_client(argv):
    """Stream a wav file to the online server and print result events
    (reference: aslp-onlinebin/aslp-audio-provider-client.cc — sends
    PCM chunks, prints partial/final results until EOS)."""
    @dataclasses.dataclass
    class Flags(Config):
        host: str = "127.0.0.1"
        port: int = 5010
        chunk_ms: int = 250
        realtime: bool = False   # sleep chunk_ms between sends

    flags = Flags()
    args = parse_options(
        argv, [flags], "aslp-audio-provider-client wav-file", 1, 1,
    )
    from kaldi_aslp_tpu.io import read_wave

    wave = read_wave(args[0])
    samples = wave.data[0]
    pcm = np.clip(samples, -32768, 32767).astype("<i2").tobytes()
    chunk_bytes = 2 * int(wave.samp_freq * flags.chunk_ms / 1000.0)

    async def run():
        reader, writer = await asyncio.open_connection(
            flags.host, flags.port)

        async def pump():
            for i in range(0, len(pcm), chunk_bytes):
                writer.write(pcm[i:i + chunk_bytes])
                await writer.drain()
                if flags.realtime:
                    await asyncio.sleep(flags.chunk_ms / 1000.0)
            writer.write_eof()

        async def results():
            while True:
                line = await reader.readline()
                if not line:
                    break
                event = json.loads(line)
                print(f"{event['type']}: {event.get('text', '')}",
                      flush=True)

        await asyncio.gather(pump(), results())
        writer.close()

    asyncio.run(run())
    return 0
