"""Phase-1 training layer (port of ``gan_control_tpu.training``): the GAN
losses and regularizers, the reg-ratio Adam and EMA state, and the four
train steps."""
