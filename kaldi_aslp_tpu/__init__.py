"""kaldi_aslp_tpu — a JAX-native hybrid-ASR framework.

A from-scratch re-design of the capabilities of robin1001/kaldi-aslp
(nnet1-era hybrid HMM/NN + CTC speech recognition toolkit) in JAX:

- compute path: JAX / XLA / Pallas, jit + shard_map over device meshes
- model zoo: DNN / CNN / LSTM(P) / BLSTM / LC-BLSTM / GRU / CIFG-LSTM /
  cFSMN / row-convolution graph networks (reference: src/aslp-nnet/)
- losses: CE / MSE / multi-task / CTC (reference: src/aslp-nnet/nnet-loss.*,
  ctc-loss.*)
- distributed: BSP data-parallel psum + BMUF outer optimizer
  (reference: src/aslp-parallel/)
- bootstrap: GMM-HMM mono/deltas training, decision trees, WFST graph
  build and lattice beam decoding (reference: src/{gmm,hmm,tree,fstext,
  decoder,lat}/)
- apps: VAD, KWS, online streaming decode (reference: src/aslp-{vad,kws,
  online}/)

Interop: reads/writes Kaldi ark/scp tables so reference-produced
features, alignments, and models can be compared 1:1.
"""

__version__ = "0.1.0"
