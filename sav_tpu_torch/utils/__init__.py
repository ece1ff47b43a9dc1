"""sav_tpu_torch.utils"""
