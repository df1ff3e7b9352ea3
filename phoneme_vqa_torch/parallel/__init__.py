"""Training across cards (counterpart of ``phoneme_vqa_tpu/parallel/``):
``multihost`` starts ``torch.distributed``, ``mesh`` lays the processes out
as a (data, model) ``DeviceMesh`` with the tensor-parallel plan,
``tensor_parallel`` holds the collectives and the split layers, and
``optimizer`` the data-parallel gradient reduction, the global-norm clip
and ZeRO-1 over them."""
