from tsr_tpu_torch.models.resunet import ResUNet  # noqa: F401
from tsr_tpu_torch.models.unet import SimpleUNet  # noqa: F401
from tsr_tpu_torch.models.vgg import VGG16  # noqa: F401
