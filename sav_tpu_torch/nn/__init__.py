"""sav_tpu_torch.nn"""
